#!/usr/bin/env python3
"""Drive the PyTorch port's TCN (gLN and causal cLN, blocks singly and as
block pairs, and gLN tensor-parallel) and dual-path (DPT, also
tensor-parallel) serving and training paths, its streaming separator and
its ways in (reference packages, JAX checkpoints, a raw shorten corpus
through stage 0 and the recipe) on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each raising on failure (so the script exits nonzero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every CUDA kernel from ``convtasnet_tpu_torch/csrc`` (one nvcc
   per source, all at once, then one link);
3. kernel 1 (block forward) against its plain PyTorch twin at the serving
   shape ([8, 3199, 256], H=512), every dilation 1..128, gLN non-causal
   and cLN causal, bf16 and f32, at the relative-L2 bars of the JAX
   package's Pallas probe gate (4e-2 / 2e-3);
4. kernels 2 (gLN block backward) and 3 (cLN block backward) against
   their twin (autograd through the plain block) at the same shape: gLN
   non-causal at every dilation plus a causal case, cLN causal at every
   dilation plus non-causal at d=4 and d=128, each with one case of a
   negative PReLU slope, bf16 and f32: all ten cotangents finite and
   within the JAX train gate (loss = sum of the output, twice the
   forward's bars: 8e-2 / 4e-3); and with a random cotangent, against
   the exact (f32) cotangents (f32 B3 against the f64 block under the
   branches, of the pre-activations within f32 rounding of 0, nearest
   its slopes): all ten within 4e-3 in f32, the eight
   besides the two PReLU slopes within 8e-2 in bf16; then the block pair:
   kernel B4 against its twin for each pair of dilations (1, 2) .. (64,
   128), gLN non-causal and cLN causal (and the other two at (4, 8)), at
   the JAX pair gate (6e-2 / 3e-3), and kernel B5 (the gLN pair backward)
   at kernel 2's gates on all 19 cotangents (the four PReLU slopes as one
   vector; one by one in f32 with every slope at 1, where no PReLU branch
   can flip), twice to the same bits; B4 against two chained kernel-1
   calls and B5 against chained kernels 1 + 2 + 2, to the bit in bf16 and
   f32 (a pair runs the singles' stages of its dtype and widths), B4 also
   at B = 1024;
5. the three DPT sublayer kernels (inter, intra, FFN) against their twins
   at the DPT quality default's widths ([8, n, 128, 256], 8 heads, F=1024)
   with the real key mask, n = 1 (100 real frames), 25 (4 s) and 94
   (15 s), bf16 and f32, on the valid rows: 4e-2 in bf16, and in f32
   1e-5, tighter than the probe gate's 2e-3 because only the summation
   order differs there, and in f32 on rows of variance ~1e-3, where an LN
   eps off by 10x moves the output by ~4.5e-3; the bf16 kernels (B7, B9,
   B11: their Hopper designs) also within 1e-3 of the forward at their
   rounding points; then their backward kernels
   (B8, B10, B12) at the same shapes, the intra one also at 256-frame
   chunks, with a random cotangent zero on the padded rows: every
   cotangent (dx on the valid rows) against the twin's exact f32
   cotangents, in f32 within 1e-5 (the kernels read <= 1.5e-6), in bf16
   within 4e-2 of the bf16 twin and no further from exact than
   max(4e-2, 1.25x the bf16 twin's own distance); the intra forward and
   backward in f32 with a head width of 64 at S = 256, their [S, d]
   tiles in the device workspace, against the exact twin within 1e-5;
   and above 256 frames, on their row-statistics core
   (``csrc/dpt_intra_rowstat.cuh``): head width 32 at S = 320 and 512,
   16 and 128 at S = 320, and B9p / B10p on one shard of m = 2 at S =
   320, within 1e-5 of the exact twin, each backward twice to the same
   bits; the partial kernels B7p-B12p (one shard's head group or hidden slice,
   the projection alone; ``partial=True``) at the quality default's shard
   widths, m = 2 (Bq 128, 4 heads, F/m 512) and m = 4 (Bq 64, 2 heads,
   256), at [8, 25, 128, 256], bf16 and f32, against their partial twins
   at the DPT bars (the bf16 forwards also at their rounding points), and
   the Megatron identity in f32 (the shards' partials
   summed plus the residual, plus b_down, against the full kernel, and
   the backwards' dx, dgamma and dbeta summed against the full backward)
   within 1e-5; B12 and B12p (m = 2, 4) at x [8, 3199, 256], whose last
   128-row tile is partial, bf16 and f32, at the same bars; then kernel B6
   (stage 2 of a TCN block under tensor parallelism) against its twin at
   [8, 3199, Hs], Hs = 256 and 128 (two and four shards of H = 512), every
   dilation, gLN non-causal and causal, bf16 and f32, and in bf16 at Hs =
   512 and 64 (the other widths of its wgmma stage): z and the gLN-2 sums
   within the forward bars, twice to the same bits; then auto mode
   (``use_pallas=None``, the CLI's default): a paper-config TCN at B = H =
   96 and a DPT quality default with 100-frame chunks and F = 1000, widths
   off the kernels' tiles, each serve a batch and train a step through the
   kernels, padded, within the bf16 forward bar of the plain model, and so
   does a DPT at ``--B 96`` (3 heads of 32; B and every head group off 64,
   padded with zero columns and a zero head); a DPT at ``--B 96
   --dpt-heads 2`` (a head width of 48), which no kernel takes, raises
   before any launch;
6. the TCN serving path: ``separate`` on four seeded 4 s mixtures with a
   paper-config model (random weights from seed 0) in bf16 and in f32,
   through the block pairs (``CONVTASNET_PAIR_FUSION=1``: B4 16 times per
   batch), through the single blocks (``=0``: kernel 1 32 times) and
   through the plain ops: 12 wavs each, finite and of the right length,
   the kernel paths within the forward bars of the plain path and equal to
   each other (in bf16 within the pair gate); ``tp_forward`` of the same config at B=8 x 4 s over two and
   four shards on cuda:0, bf16 and f32: 32 m launches of B6 and no other
   TCN kernel, within the forward bars of the unsharded kernel and plain
   paths;
7. the training path: ``cli preprocess`` and ``cli train`` in process on a
   seeded two-speaker wav corpus at the paper config, bf16,
   ``--use-pallas 1``, one epoch of 4 steps at batch 8 and a cv pass, with
   pairs on (B4 and B5 16 times per step, B4 16 times per cv batch, no
   kernel 1 or 2) and off (kernels 1 and 2 32 times per step, kernel 1 32
   times per cv batch): every step's loss finite, and the best-model
   package separating a mixture on the card; then, pairs on, the same with
   ``--norm-type cLN --causal 1``: kernels 1 and 3 32 times per step (a
   cLN pair trains as two blocks; kernel 2 and B5 never), B4 16 times per
   cv batch, and its package serving on the card offline (``separate``
   with pairs on, 16 launches of B4 per batch, and off, 32 of kernel 1),
   ``cli separate --streaming 1`` and ``cli
   stream-demo`` (finite wavs of the right length; the streaming step
   launches no kernel, as the JAX one reaches no Pallas kernel); then
   ``cli train --n-model 2 --use-pallas 1`` at the paper config, bf16, on
   the same corpus (B6 64 times per step and per cv batch, no other TCN
   kernel; its placement line printed) and its package served through
   ``cli separate --tensor-parallel 2`` (64 B6 per batch) within the bf16
   bar of the unsharded ``cli separate``; the same for the DPT quality
   default, ``cli train --separator dpt --n-model 2`` (the partial kernels
   2 x (4, 4, 8) times per step forward and backward, per cv batch
   forward, no full-mode launch) and ``cli separate --tensor-parallel 2``;
8. the DPT serving path: the quality-default forward in bf16 at
   B=8 x 4 s, kernel path against plain path within 4e-2, 4 inter, 4
   intra and 8 FFN launches per forward; then ``cli separate`` and
   ``cli evaluate`` on a DPT inference package over 8 seeded utterances
   with sources: the kernels launched per batch, the wavs finite, SI-SNRi
   finite and the kernel path within 0.05 dB of the plain path;
   ``tp_forward`` of the quality default (biases and norm affines moved
   off their init) over two and four shards, bf16 and f32: m x (4, 4, 8)
   partial launches and no full-mode one, within 4e-2 / 1e-5 of the
   unsharded kernel path; then
   ``cli train --separator dpt`` at the quality default, bf16,
   ``--use-pallas 1``, on phase 7's corpus (4 steps at batch 8 and a cv
   pass): every loss finite, per step 4 / 4 / 8 launches of the inter,
   intra and FFN forward kernels and of their backward kernels, the cv
   batches forward only, and the best-model package separating a mixture
   on the card; then the same in f32 with 512-frame chunks (``--dpt-chunk
   512``, B9 and B10 on their row-statistics core), its package through
   ``separate`` on the kernels (4 / 4 / 8 launches) and on the plain ops,
   the wavs within 2e-3 of each other; then the DPT at ``--B 512`` (16
   heads of 32, F = 1024; its kernels on their wide routes above 256,
   ``phase_dpt_wide``): B7-B12 alone at [8, 25, 128, 512] and 320, and
   B7p-B12p at 512 on one shard of two, against their twins (4e-2 / 1e-5;
   bf16 also at its rounding points), one forward and one train step in
   bf16 and f32 kernel path against plain path (the forward and step
   bars; exact launch counts), ``cli train --B 512 --n-model 2`` through
   B7p-B12p and its package through ``cli separate --tensor-parallel 2``,
   and each kernel's device time there beside its twin's and its bound;
   then the DPT above 512 (``phase_dpt_wider``: the routes beside the
   resident tiles): B7-B12 alone at [8, 25, 128, 1024] and 576 and
   B7p-B12p at 1024 on one shard of two against their twins, B = 512
   padded to 576 with the LN over its first 512 columns against B = 512
   (the forwards and the cotangents of ``WIDER_BITS`` bit for bit), the
   quality default at ``--B 1024`` and ``--B 576`` served (bf16, f32) and
   stepped (f32 at both, bf16 over three seeds at 1024) against plain,
   ``cli train`` / ``separate`` / ``evaluate`` under ``--use-pallas -1``
   at ``--B 1024`` bf16 and ``--B 576`` f32, ``cli train --B 1024
   --n-model 2`` and ``separate --tensor-parallel 2`` (exact launch
   counts), and each kernel's device time at 1024 with ``torch.matmul``
   at the products' shapes; then the DPT widths off the kernels' 64-column
   tile, which the wrappers
   zero-pad (zero columns, zero heads; each LN over the sublayer's own B,
   ``phase_dpt_padded``): B7-B12 alone at [8, 25, 128, B], B = 96, 160
   and 480, and B7p-B12p on shards of 32 channels (B = 256 over 8) and 96
   (B = 192 over 2), against their twins (4e-2 / 1e-5; bf16 also at its
   rounding points; each backward twice to the same bits), the DPT at
   ``--B 96`` (3 heads of 32) served in bf16 and f32 and stepped in f32
   kernel path against plain path, and ``cli train --B 192 --n-model 2``
   through B7p-B12p on 96-channel shards and its package through ``cli
   separate --tensor-parallel 2``, launches exact;
9. the streaming separator on the card, f32, the paper widths with the
   causal cLN norm: two 4 s mixtures in 8 ms chunks rounded down to whole
   hops (7.5 ms), the stream plus its flush against the offline causal
   forward on the left-padded input, the plain path within STREAM_TOL and
   the kernel path within 2e-3 with pairs on (16 B4) and off (32 kernel
   1), the two the same bits; ``stream_demo`` at 8 ms, its wav against the
   stream within one PCM-16 step, and its latencies;
10. the ways in, each through the kernels with exact launch counts: a
   reference PyTorch package at the paper config (gLN) and a cLN causal
   one (8 blocks; k = 3 in the reference layout), random weights from
   ``tests/torch_oracle.make_state_dict``, through ``cli import-torch``,
   then ``cli separate`` in f32 and bf16, pairs on and off, against
   ``torch_oracle.forward`` on the card (4e-2 / 2e-3), and ``cli
   export-torch`` back bit for bit; the committed JAX fixtures
   (``tests/fixtures``, a small TCN and DPT, f32) served plain within 5e-4
   and through the kernels within 2e-3 of JAX's stored estimates and by
   ``cli separate``, and ``cli train --continue-from`` the TCN one, whose
   step counts continue from the fixture's; a WSJ0-like tree of shorten
   ``.wv1`` files through ``cli prepare --wsj0-root`` (each decoded source
   equal to its samples) and ``cli recipe`` stages 1-4 at the paper
   config;
11. one train step's loss and gradients, kernel path against plain path,
   from the same init and batch (B=4 x 4 s, batch seeds 11 and 12 for the
   TCN, 11-13 for the DPT), for the TCN paper config, its causal cLN
   variant and the DPT quality default, per seed: in f32 the loss within
   1e-5, the global gradient within 4e-3, every multi-element leaf
   correlated >= 0.9999 (a leaf with no correlation, such as an all-zero
   gradient, fails) and the PReLU slopes within 4e-3 as one vector (the
   TCN's; the DPT has no scalar leaves); in bf16 the loss within 4e-2 and
   the kernel path's gradient no further from the f32 gradient than
   max(8e-2, 1.25x the plain bf16 path's) for the TCN, and for the DPT
   2x at each seed and 1.25x by the medians over the seeds; the gLN
   kernel path with pairs on and off (the same gradient bits in bf16 and
   f32) and the
   tensor-parallel step over two shards (64 B6 launches), each kernel's
   launches exact; the DPT's tensor-parallel step over two shards (the
   partial kernels 2 x (4, 4, 8) times forward and backward); and one
   bf16 DPT step each with 256-frame and with 320-frame chunks (past the
   f32 intra kernels' first designs) over batch seeds 13-15,
   held as the DPT step above is, the intra backward at
   S = 256 and 320, with one bf16 forward at S = 320 through B9 against
   the plain path, and the f32 model at S = 320 (B9 and B10 on their
   row-statistics core): one forward against the plain path within 2e-3
   and one train step's gradient within 4e-3, launches exact; the bf16 DPT at head widths 128 (2 heads) and 16 (16 heads):
   one forward through B7, B9 and B11 against the plain path and one step
   over three batch seeds through B8 and B10, as the S = 320 step is held,
   with exact launch counts; and the f32 model at those widths through
   the f32 kernels: one forward against the plain path within the f32
   forward bar (2e-3) and one train step's gradient within the f32 step
   bar (4e-3), with exact launch counts;
12. the TCN at more than 16 depthwise taps (``phase_tcn_taps``; the JAX
   package runs any P causal and any odd P otherwise, and the kernels
   take them past the 16 taps of their first routes): each TCN kernel
   alone at [8, 3199, 256], H = 512, at P = 17 and 33, d = 1 and 128,
   bf16 and f32, against its twin (B1 gLN, cLN causal and BN at the
   forward bars, B2 and B3 at a random cotangent against the exact f32
   cotangents at phase 4's gate, B4 and B5 at (64, 128) at the pair gate
   and phase 4's B5 gate, B6 at Hs = 256 at the forward bars and its
   rounding points), at P = 16 causal (the old limit), and the bf16 cLN
   B1 at P = 47, d = 128 on one sample of K = 6,000 frames (its C' halo
   of statistics past shared memory); a block of 17 taps whose extra taps
   are zero against the block of 16 (causal) or 15 taps on the first
   routes, B1 (gLN, cLN, BN), B2, B3, B5 and B6 the same bits; the paper
   config at P = 17 served at B=8 x 4 s kernel path against plain path at
   the forward bars (gLN pairs off, 32 B1, and on, 16 B4; cLN causal, 32
   B1; gLN over two shards, 64 B6) and one train step as phase 11 holds
   it (batch seed 11: gLN pairs on, 16 B4 and 16 B5, off, 32 B1 and 32
   B2, over two shards, 64 B6; cLN causal, 32 B1 and 32 B3), launches
   exact;
13. timings (CUDA events, warm-ups excluded): the bf16 TCN forward at
   B=8 and B=24 x 4 s and the bf16 train step (forward + backward +
   optimizer) at B=8 x 4 s, kernel path with pairs on and off and plain
   path, with peak memory, for the paper config, and the kernel and plain
   steps of its causal cLN variant; the kernel paths' train step at B=24 x
   4 s; each TCN kernel against its twin per dilation (kernel 3 causal);
   B4 and B5 against two kernel-1 (kernel-2) calls and their twins per
   pair of dilations; each DPT
   kernel, forward and backward, against its twin at [8, 25, 128, 256],
   and the attention kernels alone at head widths 16 and 128, and in f32
   at head widths 16, 32, 64 and 128 in device time (torch.profiler); the
   DPT
   forward and the DPT train step at B=8 x 4 s, kernel path and
   plain path (the steps with each path's peak memory); B6 against its
   twin per shard width (Hs 256 and 128), and the bf16 forward over two
   and four shards and the train step over two against the unsharded
   kernel path, with peak memory; each partial kernel, forward and
   backward, against its twin on one shard of m = 2 and 4, and the DPT
   forward over two and four shards and its train step over two against
   the unsharded kernel path, with peak memory; each kernel's bound (the
   larger of its operations at the bf16 tensor-core peak and its bytes at
   the HBM rate).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SAMPLE_RATE = 8000
SECONDS = 4
TOL = {"bfloat16": 4e-2, "float32": 2e-3}   # tcn_block.py _numerics_tol
BWD_TOL = {k: 2 * v for k, v in TOL.items()}  # the train gate, :1148
# the DPT kernels in f32 differ from their twins only in summation order
# (<= 4e-7 here); 2e-3 would let erf-GELU for tanh-GELU (~1e-4) through
DPT_TOL = {"bfloat16": 4e-2, "float32": 1e-5}
# the stream against the offline plain forward in f32: the same math in
# another summation order
STREAM_TOL = 1e-5
DILATIONS = [2 ** i for i in range(8)]
# an H100 SXM's published dense bf16 tensor-core rate and HBM3 bandwidth (at
# its full 700 W power limit): the floors that bound_ms is taken against
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores (FMA)
PEAK_3XTF32 = 495e12 / 3  # f32 as three TF32 tensor-core products
PEAK_BYTES_S = 3.35e12
GRAD_NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
              "dg1", "db1", "dg2", "db2")
# a block pair's gate: 1.5x the block's, as JAX's _pair_numerics_tol
PAIR_TOL = {k: 1.5 * v for k, v in TOL.items()}
PAIRS = [(1, 2), (4, 8), (16, 32), (64, 128)]
PAIR_GRAD_NAMES = ("dx",) + tuple(
    f"{n}_{blk}" for blk in ("a", "b") for n in GRAD_NAMES[1:])
# the launch counters of the TCN kernels: name -> (module key, wrapper,
# counter)
TCN_COUNTERS = {"b1": ("tcn", "fused_tcn_block", "launches"),
                "b2": ("bwd", "fused_tcn_block_bwd", "launches"),
                "b3": ("bwd", "fused_tcn_block_bwd", "cln_launches"),
                "b4": ("pair", "fused_tcn_block_pair", "launches"),
                "b5": ("pair_bwd", "fused_tcn_block_pair_bwd", "launches"),
                "b6": ("tp", "fused_tp_stage2", "launches")}
# tensor-parallel shard counts of the paper config's H = 512: B6 runs at
# Hs = 256 and 128
TP_SHARDS = (2, 4)
# B6 against its twin at its own rounding points (only y g2 and z rounded):
# summation order alone, ~4.5e-5 in bf16 at these widths (emulated on the
# CPU); a kernel with g2 folded into W_out reads ~3.6e-3
TP_ORDER_TOL = {"bfloat16": 1e-3, "float32": 1e-5}


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-12)).item()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def block_inputs(torch, dtype, dilation_seed: int, M=8, K=3199, B=256,
                 H=512, P=3, a2=0.25):
    """Seeded block operands on the card, at paper-init scales with random
    norm affines so every term of the block counts."""
    g = torch.Generator(device="cuda").manual_seed(1000 + dilation_seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = rn(M, K, B).to(dtype)
    w_in = (rn(B, H) * (2.0 / (B + H)) ** 0.5).to(dtype)
    dw = (rn(P, H) * (2.0 / (P + H * P)) ** 0.5).to(dtype)
    w_out = (rn(H, B) * (2.0 / (B + H)) ** 0.5).to(dtype)
    a1 = torch.tensor(0.25, device="cuda")
    a2 = torch.tensor(a2, device="cuda")
    g1, g2 = 1.0 + 0.1 * rn(H), 1.0 + 0.1 * rn(H)
    b1, b2 = 0.1 * rn(H), 0.1 * rn(H)
    return (x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2)


def tcn_modules():
    """The TCN kernels' wrapper modules, as the launch counters read them."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block, tcn_block_bwd
    from convtasnet_tpu_torch.ops.cuda import tcn_block_pair
    from convtasnet_tpu_torch.ops.cuda import tcn_block_pair_bwd
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp

    return {"tcn": tcn_block, "bwd": tcn_block_bwd, "pair": tcn_block_pair,
            "pair_bwd": tcn_block_pair_bwd, "tp": tcn_block_tp}


def tcn_reset(k) -> None:
    for mod, fn, attr in TCN_COUNTERS.values():
        setattr(getattr(k[mod], fn), attr, 0)


def tcn_counts(k) -> dict:
    return {name: getattr(getattr(k[mod], fn), attr)
            for name, (mod, fn, attr) in TCN_COUNTERS.items()}


def tcn_want(**nonzero) -> dict:
    """Expected TCN launch counts: the named ones, every other 0."""
    return {**dict.fromkeys(TCN_COUNTERS, 0), **nonzero}


class pair_switch:
    """CONVTASNET_PAIR_FUSION set to 1 (blocks run as pairs) or 0 (every
    block singly) inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = os.environ.get("CONVTASNET_PAIR_FUSION")
        os.environ["CONVTASNET_PAIR_FUSION"] = "1" if self.on else "0"
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("CONVTASNET_PAIR_FUSION", None)
        else:
            os.environ["CONVTASNET_PAIR_FUSION"] = self.old


def pair_inputs(torch, dtype, d1: int, a2b=0.25, slopes_a=None):
    """A pair's seeded operands at the serving shape: x and the two
    blocks' nine weights (block 2's second slope a2b; block 1's two slopes
    slopes_a where given)."""
    x, *pa = block_inputs(torch, dtype, d1)
    _, *pb = block_inputs(torch, dtype, 500 + d1, a2=a2b)
    if slopes_a is not None:
        pa[3], pa[4] = (torch.tensor(a, device="cuda") for a in slopes_a)
    return x, pa, pb


def time_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_vs_twin(torch, tcn, norm: str = "gLN",
                         causal: bool = False):
    """Kernel 1 against its twin at every dilation, bf16 and f32, for the
    paper config's gLN (non-causal) or the causal cLN model."""
    worst_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d in DILATIONS:
            args = block_inputs(torch, dtype, d)
            kw = dict(dilation=d, causal=causal, norm_type=norm)
            got = tcn.fused_tcn_block(*args, **kw)
            torch.cuda.synchronize()
            want = tcn.fused_tcn_block_reference(*args, **kw)
            torch.cuda.synchronize()
            err = rel_l2(got, want)
            abs_err = (got.float() - want.float()).abs().max().item()
            worst_abs = max(worst_abs, abs_err)
            print(f"kernel vs twin [8,3199,256] H=512 {norm} causal="
                  f"{int(causal)} {name} d={d}: rel_l2 {err:.3e} (bar "
                  f"{TOL[name]:.0e}) max_abs {abs_err:.3e}", flush=True)
            check(torch.isfinite(got).all().item(), f"non-finite kernel "
                  f"output at d={d} {name}")
            check(err <= TOL[name], f"kernel disagrees with its twin at "
                  f"d={d} {name}: {err:.3e}")
    return worst_abs


def phase_bwd_vs_twin(torch, bwd, norm: str = "gLN"):
    """Kernel 2 (gLN) or kernel 3 (cLN) against its twin on all ten
    cotangents. gLN: non-causal at every dilation, one causal case and one
    with a negative second slope; cLN: causal at every dilation,
    non-causal at d=4 and d=128, and one causal case with a negative
    second slope.

    The first gate is the JAX train gate (``_train_grads_numerics``):
    cotangents of loss = sum(block output), i.e. g = ones, against autograd
    through the plain block in the same dtype, max relative L2 over the
    ten. A constant cotangent hides a bug in how g is indexed per row or
    per sample, so a random cotangent is held too, against the twin
    evaluated in f32 on the same values (f32 B3 against the f64 block
    under the branches of the pre-activations within f32 rounding of 0
    that put its slopes nearest, ``f64_nearest_branches``, the f32 twin's
    own distance from the f64 block printed): all ten within the f32 bar
    in f32, and in bf16 the eight besides the PReLU slopes within the bf16
    bar. The slope cotangents are sums of 13 M cancelling terms, and in
    bf16 no evaluation lands within the bar of their exact values (the
    bf16 twin's own distance is printed beside the kernel's). Every case
    is run and printed before the phase fails."""
    if norm == "gLN":
        cases = ([(d, False, 0.25) for d in DILATIONS]
                 + [(16, True, 0.25), (4, False, -0.1)])
    else:
        cases = ([(d, True, 0.25) for d in DILATIONS]
                 + [(4, False, 0.25), (128, False, 0.25), (16, True, -0.1)])
    worst_abs, worst_at = 0.0, ""
    failures = []

    def errors(got, want):
        return {n: rel_l2(q, r) for n, q, r in zip(GRAD_NAMES, got, want)}

    def fmt(errs):
        worst = max(errs, key=errs.get)
        return f"{errs[worst]:.3e} ({worst})"

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d, causal, a2 in cases:
            x, *w = block_inputs(torch, dtype, d, a2=a2)
            kw = dict(dilation=d, causal=causal, norm_type=norm)
            g = torch.ones_like(x)
            got = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
            torch.cuda.synchronize()
            want = bwd.fused_tcn_block_bwd_reference(x, g, *w, **kw)
            torch.cuda.synchronize()
            for gname, q, r in zip(GRAD_NAMES, got, want):
                check(q.shape == r.shape and q.dtype == r.dtype,
                      f"{gname}: {q.shape} {q.dtype} vs {r.shape} {r.dtype}")
                if not torch.isfinite(q).all().item():
                    failures.append(f"non-finite {gname} at d={d} {name}")
                abs_err = (q.float() - r.float()).abs().max().item()
                if abs_err > worst_abs:
                    # the cotangents' scales differ by orders of magnitude:
                    # name the one and its size beside the error
                    worst_abs = abs_err
                    worst_at = (f"{gname} {name} d={d}, where max |twin| is "
                                f"{r.float().abs().max().item():.3e}")
            gate = errors(got, want)

            g = torch.randn(x.shape, generator=torch.Generator(
                device="cuda").manual_seed(2000 + d), device="cuda").to(dtype)
            got = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
            exact = bwd.fused_tcn_block_bwd_reference(
                x.float(), g.float(), *[t.float() for t in w], **kw)
            twin = (bwd.fused_tcn_block_bwd_reference(x, g, *w, **kw)
                    if dtype == torch.bfloat16 else exact)
            note = ""
            if dtype == torch.float32 and norm == "cLN":
                exact, twin_ref, note = f64_nearest_branches(
                    torch, x, g, w, d, causal, norm, got, BWD_TOL[name])
                note = f"; f64 branches: {note}"
            else:
                twin_ref = exact
            torch.cuda.synchronize()
            if not all(torch.isfinite(q).all().item() for q in got):
                failures.append(f"non-finite cotangent (random g) at d={d} "
                                f"{name}")
            k_err = errors(got, exact)
            held = {n: v for n, v in k_err.items()
                    if dtype == torch.float32 or n not in ("da1", "da2")}
            print(f"bwd kernel vs twin [8,3199,256] H=512 {norm} {name} d={d} "
                  f"causal={int(causal)} a2={a2}: gate (g=1) {fmt(gate)}, "
                  f"bar {BWD_TOL[name]:.0e}; random g vs exact: kernel "
                  f"{fmt(k_err)}, held {fmt(held)}, dx {k_err['dx']:.3e}, "
                  f"dW_in {k_err['dW_in']:.3e}"
                  + (f", {name} twin {fmt(errors(twin, twin_ref))}"
                     if dtype == torch.bfloat16 or norm == "cLN" else "")
                  + note, flush=True)
            if max(gate.values()) > BWD_TOL[name]:
                failures.append(f"g=1 gate at d={d} {name}: {fmt(gate)}")
            if max(held.values()) > BWD_TOL[name]:
                failures.append(f"random g at d={d} {name}: {fmt(held)}")
    print(f"bwd kernel vs twin {norm} (g=1): max_abs_err {worst_abs:.3e} "
          f"at {worst_at}", flush=True)
    check(not failures, f"{norm} backward kernel disagrees with its twin: "
          + "; ".join(failures))
    return worst_abs


def phase_pair_vs_twin(torch, k):
    """Kernel B4 (the block pair) against its twin at the serving shape for
    each pair (1, 2), (4, 8), (16, 32), (64, 128): gLN non-causal and cLN
    causal, plus gLN causal and cLN non-causal at (4, 8), bf16 and f32, at
    the JAX pair gate (1.5x the block's: 6e-2 / 3e-3). Beside it, B4
    against two chained kernel-1 calls, in bf16 and f32: a pair runs kernel
    1's stages of its dtype and widths on the same operands, so it gives
    the same bits. Every case is printed before the phase fails; returns
    the worst max_abs_err against the twin."""
    pair, tcn = k["pair"], k["tcn"]
    cases = ([(d1, d2, "gLN", False) for d1, d2 in PAIRS]
             + [(d1, d2, "cLN", True) for d1, d2 in PAIRS]
             + [(4, 8, "gLN", True), (4, 8, "cLN", False)])
    worst, failures = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d1, d2, norm, causal in cases:
            x, pa, pb = pair_inputs(torch, dtype, d1)
            kw = dict(d1=d1, d2=d2, causal=causal, norm_type=norm)
            got = pair.fused_tcn_block_pair(x, pa, pb, **kw)
            torch.cuda.synchronize()
            want = pair.fused_tcn_block_pair_reference(x, pa, pb, **kw)
            x1 = tcn.fused_tcn_block(x, *pa, dilation=d1, causal=causal,
                                     norm_type=norm)
            two = tcn.fused_tcn_block(x1, *pb, dilation=d2, causal=causal,
                                      norm_type=norm)
            torch.cuda.synchronize()
            err = rel_l2(got, want)
            abs_err = (got.float() - want.float()).abs().max().item()
            vs_two = (got.float() - two.float()).abs().max().item()
            rel_two = rel_l2(got, two)
            worst = max(worst, abs_err)
            print(f"pair kernel vs twin [8,3199,256] H=512 {norm} causal="
                  f"{int(causal)} {name} d=({d1},{d2}): rel_l2 {err:.3e} (bar "
                  f"{PAIR_TOL[name]:.0e}) max_abs {abs_err:.3e}; vs two "
                  f"kernel-1 calls max_abs {vs_two:.3e} rel_l2 "
                  f"{rel_two:.3e}", flush=True)
            if not torch.isfinite(got).all().item() or err > PAIR_TOL[name]:
                failures.append(f"{norm} causal={int(causal)} {name} "
                                f"d=({d1},{d2}): {err:.3e}")
            if not torch.equal(got, two):
                failures.append(f"{norm} {name} d=({d1},{d2}): not the bits "
                                f"of two kernel-1 calls ({vs_two:.3e})")
    # a pair at B = 1024, past the bf16 Hopper stages' widths (the pair
    # kernels take any B the single block takes): two kernel-1 calls' bits
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, *pa = block_inputs(torch, dtype, 4, B=1024)
        _, *pb = block_inputs(torch, dtype, 504, B=1024)
        kw = dict(causal=False, norm_type="gLN")
        before = pair.fused_tcn_block_pair.launches
        got = pair.fused_tcn_block_pair(x, pa, pb, d1=4, d2=8, **kw)
        launched = pair.fused_tcn_block_pair.launches - before
        two = tcn.fused_tcn_block(tcn.fused_tcn_block(x, *pa, dilation=4,
                                                      **kw),
                                  *pb, dilation=8, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, two)
        print(f"pair kernel [8,3199,1024] H=512 gLN {name} d=(4,8): "
              f"{launched} launch, the bits of two kernel-1 calls: {same}",
              flush=True)
        if not (same and launched == 1 and torch.isfinite(got).all().item()):
            failures.append(f"B=1024 {name}: same bits {same}, launches "
                            f"{launched}")
    check(not failures, "pair kernel disagrees: " + "; ".join(failures))
    return worst


def pair_grads(out):
    """(dx, grads_a, grads_b) as one flat tuple of 19."""
    return (out[0], *out[1], *out[2])


def f64_pair_cotangents(torch, x, g, pa, pb, d1: int, d2: int,
                        causal: bool):
    """The gLN pair's 19 cotangents with every product and statistic in
    float64 (autograd through the block's math): the witness that says
    which of two f32 evaluations sits nearer the value."""
    from convtasnet_tpu_torch.ops.conv import depthwise_conv1d, prelu
    from convtasnet_tpu_torch.ops.norm import global_layer_norm

    def block(y, p, d):
        w_in, dw, w_out, a1, a2, g1, b1, g2, b2 = p
        h = global_layer_norm(prelu(y @ w_in, a1), g1, b1)
        h = global_layer_norm(prelu(depthwise_conv1d(h, dw, d, causal), a2),
                              g2, b2)
        return y + h @ w_out

    prims = [t.detach().double().requires_grad_(True)
             for t in (x, *pa, *pb)]
    with torch.enable_grad():
        out = block(block(prims[0], prims[1:10], d1), prims[10:], d2)
        cots = torch.autograd.grad(out, prims, g.double())
    return cots[0], cots[1:10], cots[10:]


def phase_pair_bwd_vs_twin(torch, k):
    """Kernel B5 (the gLN pair backward) against its twin on all 19
    cotangents at the serving shape, for each pair non-causal, causal at
    (4, 8), one case with block 2's second slope negative and one with
    block 1's slopes off the powers of two (0.3, 0.2: there a PReLU of a
    rounded pre-activation is not the rounded PReLU), at kernel
    2's gates: the JAX train gate (g = 1, against the twin in the same
    dtype, 8e-2 / 4e-3) and a random cotangent against exact f32 (within
    4e-3 in f32; in bf16 the 15 besides the four slopes within 8e-2, the
    bf16 twin's own distance printed beside). dx and the 14 weight and
    affine gradients are held each, the four PReLU-slope gradients as one
    vector, as the train-step comparison holds a model's: each is a sum of
    M*K*H cancelling terms, block 1's taken through block 2's backward,
    and a pre-activation within rounding of 0 that the two evaluations put
    on opposite PReLU branches moves one by 1e-2 in f32
    (``scripts/tcn_bwd_outliers.py``); each slope's reading is printed.
    In f32 each slope's distance from a float64 evaluation is printed for
    kernel and twin. Then at each pair in f32 with every slope at 1, where
    no branch flip moves a slope gradient, all 19 one by one against exact
    f32 and against float64, at 4e-3.
    B5 run twice gives the same bits, and equals chained kernel 1 + 2 + 2
    (block 2's backward at x1, then block 1's at its cotangent) to the bit
    in bf16 and f32: a pair runs the singles' stages of its dtype and
    widths on the same operands; kernel 2's own gates hold each block.
    Every case is printed before the phase fails; returns the worst
    max_abs_err against the twin (g = 1)."""
    pair_bwd, tcn, bwd = k["pair_bwd"], k["tcn"], k["bwd"]
    cases = ([(d1, d2, False, 0.25, None) for d1, d2 in PAIRS]
             + [(4, 8, True, 0.25, None), (1, 2, False, -0.1, None),
                (16, 32, False, 0.25, (0.3, 0.2))])
    slopes = [n for n in PAIR_GRAD_NAMES if n.startswith(("da1", "da2"))]
    worst, worst_at, failures = 0.0, "", []

    def errors(got, want):
        """Relative L2 of each cotangent but the slopes, and of the four
        slopes as one vector ("slopes")."""
        q = dict(zip(PAIR_GRAD_NAMES, pair_grads(got)))
        r = dict(zip(PAIR_GRAD_NAMES, pair_grads(want)))
        errs = {n: rel_l2(q[n], r[n]) for n in PAIR_GRAD_NAMES
                if n not in slopes}
        errs["slopes"] = rel_l2(torch.stack([q[n].reshape(()) for n in slopes]),
                                torch.stack([r[n].reshape(()) for n in slopes]))
        return errs

    def per_slope(got, want):
        q = dict(zip(PAIR_GRAD_NAMES, pair_grads(got)))
        r = dict(zip(PAIR_GRAD_NAMES, pair_grads(want)))
        return " ".join(f"{n} {rel_l2(q[n], r[n]):.2e}" for n in slopes)

    def fmt(errs):
        top = max(errs, key=errs.get)
        return f"{errs[top]:.3e} ({top})"

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d1, d2, causal, a2b, slopes_a in cases:
            x, pa, pb = pair_inputs(torch, dtype, d1, a2b=a2b,
                                    slopes_a=slopes_a)
            kw = dict(d1=d1, d2=d2, causal=causal)
            g = torch.ones_like(x)
            got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
            torch.cuda.synchronize()
            want = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb,
                                                               **kw)
            for gname, q, r in zip(PAIR_GRAD_NAMES, pair_grads(got),
                                   pair_grads(want)):
                check(q.shape == r.shape and q.dtype == r.dtype,
                      f"{gname}: {q.shape} {q.dtype} vs {r.shape} {r.dtype}")
                abs_err = (q.float() - r.float()).abs().max().item()
                if abs_err > worst:
                    worst = abs_err
                    worst_at = (f"{gname} {name} d=({d1},{d2}), where max "
                                f"|twin| is {r.float().abs().max().item():.3e}")
            gate = errors(got, want)
            gate_slopes = per_slope(got, want)

            g = torch.randn(x.shape, generator=torch.Generator(
                device="cuda").manual_seed(2000 + d1), device="cuda").to(dtype)
            got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
            again = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
            exact = pair_bwd.fused_tcn_block_pair_bwd_reference(
                x.float(), g.float(), [t.float() for t in pa],
                [t.float() for t in pb], **kw)
            twin = (pair_bwd.fused_tcn_block_pair_bwd_reference(
                x, g, pa, pb, **kw) if dtype == torch.bfloat16 else exact)
            x1 = tcn.fused_tcn_block(x, *pa, dilation=d1, causal=causal,
                                     norm_type="gLN")
            dx1, *wb = bwd.fused_tcn_block_bwd(x1, g, *pb, dilation=d2,
                                               causal=causal)
            dx0, *wa = bwd.fused_tcn_block_bwd(x, dx1, *pa, dilation=d1,
                                               causal=causal)
            torch.cuda.synchronize()
            flat, chained = pair_grads(got), (dx0, *wa, *wb)
            repeat = all(torch.equal(u, v)
                         for u, v in zip(flat, pair_grads(again)))
            vs_chain = max((u.float() - v.float()).abs().max().item()
                           for u, v in zip(flat, chained))
            chain_err = errors(got, (dx0, wa, wb))
            if not all(torch.isfinite(q).all().item() for q in flat):
                failures.append(f"non-finite cotangent at d=({d1},{d2}) "
                                f"{name}")
            k_err = errors(got, exact)
            held = {n: v for n, v in k_err.items()
                    if dtype == torch.float32 or n != "slopes"}
            witness = ""
            if dtype == torch.float32:
                f64 = f64_pair_cotangents(torch, x, g, pa, pb, d1, d2, causal)
                witness = (f" (vs float64: kernel {per_slope(got, f64)}; "
                           f"twin {per_slope(exact, f64)})")
            print(f"pair bwd kernel vs twin [8,3199,256] H=512 gLN {name} "
                  f"d=({d1},{d2}) causal={int(causal)} a2b={a2b}"
                  f"{f' block-1 slopes {slopes_a}' if slopes_a else ''}: "
                  f"gate (g=1) "
                  f"{fmt(gate)} (each slope {gate_slopes}), bar "
                  f"{BWD_TOL[name]:.0e}; random g vs exact: kernel "
                  f"{fmt(k_err)}, held {fmt(held)}, dx {k_err['dx']:.3e} "
                  f"(each slope {per_slope(got, exact)}){witness}"
                  + (f", {name} twin {fmt(errors(twin, exact))} (each slope "
                     f"{per_slope(twin, exact)})"
                     if dtype == torch.bfloat16 else "")
                  + f"; twice the same bits {repeat}; vs chained kernels "
                  f"1+2+2 max_abs {vs_chain:.3e}, {fmt(chain_err)}",
                  flush=True)
            if max(gate.values()) > BWD_TOL[name]:
                failures.append(f"g=1 gate at d=({d1},{d2}) {name}: "
                                f"{fmt(gate)}")
            if max(held.values()) > BWD_TOL[name]:
                failures.append(f"random g at d=({d1},{d2}) {name}: "
                                f"{fmt(held)}")
            if not repeat:
                failures.append(f"two runs differ at d=({d1},{d2}) {name}")
            if not all(torch.equal(u, v) for u, v in zip(flat, chained)):
                failures.append(f"not the bits of chained kernels 1+2+2 at "
                                f"d=({d1},{d2}) {name} ({vs_chain:.3e}, "
                                f"{fmt(chain_err)})")
    for d1, d2 in PAIRS:
        # every slope at 1: PReLU is the identity, so no branch flip moves a
        # slope gradient, and all 19 are held one by one in f32
        x, pa, pb = pair_inputs(torch, torch.float32, d1)
        for p in (pa, pb):
            p[3] = p[4] = torch.ones_like(p[3])
        kw = dict(d1=d1, d2=d2, causal=False)
        g = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(3000 + d1), device="cuda")
        got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
        exact = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb,
                                                            **kw)
        f64 = f64_pair_cotangents(torch, x, g, pa, pb, d1, d2, False)
        torch.cuda.synchronize()
        each = {n: rel_l2(q, r) for n, q, r in zip(
            PAIR_GRAD_NAMES, pair_grads(got), pair_grads(exact))}
        each64 = {n: rel_l2(q, r) for n, q, r in zip(
            PAIR_GRAD_NAMES, pair_grads(got), pair_grads(f64))}
        print(f"pair bwd kernel vs twin [8,3199,256] H=512 gLN float32 "
              f"d=({d1},{d2}) slopes at 1, random g, each of the 19: "
              f"{fmt(each)} (each slope {per_slope(got, exact)}); vs "
              f"float64: kernel {fmt(each64)} (each slope "
              f"{per_slope(got, f64)}), twin each slope "
              f"{per_slope(exact, f64)}; bar {BWD_TOL['float32']:.0e}",
              flush=True)
        for ref, errs in (("twin", each), ("float64", each64)):
            if max(errs.values()) > BWD_TOL["float32"]:
                failures.append(f"slopes at 1 at d=({d1},{d2}) vs {ref}: "
                                f"{fmt(errs)}")
    print(f"pair bwd kernel vs twin (g=1): max_abs_err {worst:.3e} at "
          f"{worst_at}", flush=True)
    check(not failures, "pair backward kernel disagrees with its twin: "
          + "; ".join(failures))
    return worst


def write_corpus(root: str, split: str, n: int, rng, lo_s: float,
                 hi_s: float):
    """Seeded two-"speaker" utterances of lo_s..hi_s seconds: an
    amplitude-modulated tone and modulated noise, and their mixture."""
    import numpy as np

    from convtasnet_tpu_torch.data.audio_io import write_wav

    for part in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(root, split, part))
    for i in range(n):
        T = int(rng.uniform(lo_s, hi_s) * SAMPLE_RATE)
        t = np.arange(T) / SAMPLE_RATE
        s1 = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t) * (
            1 + 0.5 * np.sin(2 * np.pi * 0.5 * t + i))
        s2 = 0.1 * rng.standard_normal(T) * (1 + np.cos(2 * t + i))
        name = f"utt{i:03d}.wav"
        for part, sig in (("mix", s1 + s2), ("s1", s1), ("s2", s2)):
            write_wav(os.path.join(root, split, part, name),
                      sig.astype(np.float32), SAMPLE_RATE)


def check_wavs(out_dir: str, mix_dir: str) -> None:
    """Both speakers' wavs of every mixture in ``mix_dir`` written to
    ``out_dir``: finite, at the sample rate, of the mixture's length."""
    import numpy as np

    from convtasnet_tpu_torch.data.audio_io import read_wav

    for name in sorted(f for f in os.listdir(mix_dir) if f.endswith(".wav")):
        T = read_wav(os.path.join(mix_dir, name))[0].shape[0]
        for c in (1, 2):
            y, sr = read_wav(os.path.join(
                out_dir, name.replace(".wav", f"_s{c}.wav")))
            check(sr == SAMPLE_RATE and y.shape == (T,)
                  and np.isfinite(y).all(), f"bad separated {name} s{c}")


def make_corpus(work: str):
    """The seeded two-speaker corpus of the train phases, preprocessed:
    16 utterances of 4.2-6 s (2 segments of 4 s each, 4 batches of 8) and
    2 cv utterances. Returns (data dir, json dir)."""
    import numpy as np

    from convtasnet_tpu_torch import cli

    rng = np.random.default_rng(1)
    data = os.path.join(work, "corpus")
    write_corpus(data, "tr", 16, rng, 4.2, 6.0)
    write_corpus(data, "cv", 2, rng, 4.0, 6.0)
    json_dir = os.path.join(work, "json")
    check(cli.main(["preprocess", "--data-dir", data, "--out-dir",
                    json_dir]) == 0, "preprocess failed")
    return data, json_dir


def phase_train_path(torch, k, work: str, data: str, json_dir: str,
                     pairs: bool = True):
    """``cli train`` at the paper config, bf16, the kernels forced on, pairs
    on or off; then ``separate`` with the best model. Per step, pairs on:
    16 launches of B4 and of B5 and none of kernels 1 and 2; pairs off: 32
    of kernels 1 and 2; per cv batch and per separated batch the forward
    kernel of the state (16 B4 or 32 kernel 1). Returns the launch counts
    of the train run."""
    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.infer.separate import separate

    n_blocks, n_cv = 32, 2
    state = "pairs on" if pairs else "pairs off"
    out = os.path.join(work, f"exp_{'pairs' if pairs else 'singles'}")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    tcn_reset(k)
    t0 = time.perf_counter()
    with pair_switch(pairs):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--compute-dtype", "bfloat16",
            "--use-pallas", "1", "--epochs", "1", "--batch-size", "8",
            "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tcn_counts(k)
    check(rc == 0, f"cli train ({state}) returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train (paper config, bf16, --use-pallas 1, {state}): "
          f"{n_steps} steps, losses {[round(x, 4) for x in losses]}, cv loss "
          f"{[r['loss'] for r in records if r.get('split') == 'valid']}, "
          f"launches {counts}, {wall:.1f} s wall", flush=True)
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    if pairs:
        want = tcn_want(b4=n_blocks // 2 * (n_steps + n_cv),
                        b5=n_blocks // 2 * n_steps)
    else:
        want = tcn_want(b1=n_blocks * (n_steps + n_cv), b2=n_blocks * n_steps)
    check(counts == want, f"cli train ({state}) launched {counts}, expected "
          f"{want} ({n_steps} steps + {n_cv} cv batches)")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    sep_dir = os.path.join(work, f"sep_trained_{'pairs' if pairs else 'singles'}")
    tcn_reset(k)
    with pair_switch(pairs):
        n = separate(pkg, sep_dir, mix_dir=os.path.join(data, "cv", "mix"),
                     batch_size=n_cv, device="cuda")
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    sep = tcn_counts(k)
    want_sep = (tcn_want(b4=n_blocks // 2) if pairs
                else tcn_want(b1=n_blocks))
    check(n == n_cv and sep == want_sep,
          f"separate with the trained package ({state}): {n} utterances, "
          f"launches {sep}, expected {want_sep}")
    check_wavs(sep_dir, os.path.join(data, "cv", "mix"))
    print(f"separate with the trained package ({state}): {n} utterances, "
          f"launches {sep} (1 batch)", flush=True)
    return counts


def phase_cln_train_path(torch, k, work: str, data: str, json_dir: str):
    """``cli train --norm-type cLN --causal 1`` at the paper widths, bf16,
    ``--use-pallas 1``, pairs on, on the corpus of ``make_corpus``: one
    epoch of 4 steps at batch 8 and a cv pass. Every loss finite; kernels 1
    and 3 launched 32 times per step (kernel 2 and the pair kernels never:
    a cLN pair trains as two blocks, as in JAX), the pair kernel B4 16
    times per cv batch (a forward without gradients pairs its blocks). Then
    the best-model package serves on the card: offline ``separate`` with
    the pairs on (16 launches of B4 per batch) and off (32 of kernel 1),
    ``cli separate --streaming 1`` and ``cli stream-demo`` (the plain
    streaming step, no kernel launch). Returns the launch counts of the
    train run."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav
    from convtasnet_tpu_torch.infer.separate import separate

    n_blocks, n_cv = 32, 2
    out = os.path.join(work, "exp_cln")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    tcn_reset(k)
    t0 = time.perf_counter()
    with pair_switch(True):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--norm-type", "cLN", "--causal", "1",
            "--compute-dtype", "bfloat16", "--use-pallas", "1", "--epochs",
            "1", "--batch-size", "8", "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tcn_counts(k)
    check(rc == 0, f"cli train --norm-type cLN --causal 1 returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train (paper widths, cLN causal, bf16, --use-pallas 1): "
          f"{n_steps} steps, losses {[round(x, 4) for x in losses]}, cv loss "
          f"{[r['loss'] for r in records if r.get('split') == 'valid']}, "
          f"launches {counts}, {wall:.1f} s wall", flush=True)
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    want = tcn_want(b1=n_blocks * n_steps, b3=n_blocks * n_steps,
                    b4=n_blocks // 2 * n_cv)
    check(counts == want, f"cLN cli train launched {counts}, expected {want} "
          f"({n_steps} steps + {n_cv} cv batches)")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    mix_dir = os.path.join(data, "cv", "mix")
    sep_launches = {}
    for pairs in (True, False):
        state = "pairs on" if pairs else "pairs off"
        sep_dir = os.path.join(
            work, f"sep_cln_{'pairs' if pairs else 'singles'}")
        tcn_reset(k)
        with pair_switch(pairs):
            n = separate(pkg, sep_dir, mix_dir=mix_dir, batch_size=n_cv,
                         device="cuda")
        torch.cuda.synchronize()
        sep_launches[state] = tcn_counts(k)
        want_sep = (tcn_want(b4=n_blocks // 2) if pairs
                    else tcn_want(b1=n_blocks))
        check(n == n_cv and sep_launches[state] == want_sep,
              f"separate with the cLN package ({state}): {n} utterances, "
              f"launches {sep_launches[state]}, expected {want_sep}")
        check_wavs(sep_dir, mix_dir)
    stream_dir = os.path.join(work, "sep_cln_stream")
    tcn_reset(k)
    check(cli.main(["separate", "--model-path", pkg, "--mix-dir", mix_dir,
                    "--out-dir", stream_dir, "--streaming", "1"]) == 0,
          "cli separate --streaming 1 failed")
    check_wavs(stream_dir, mix_dir)
    wav = os.path.join(mix_dir, sorted(f for f in os.listdir(mix_dir)
                                       if f.endswith(".wav"))[0])
    demo_dir = os.path.join(work, "demo_cln")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["stream-demo", "--model-path", pkg, "--wav", wav,
                       "--out-dir", demo_dir])
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    check(rc == 0, f"cli stream-demo returned {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(tcn_counts(k) == tcn_want(),
          f"the streaming step launched {tcn_counts(k)}")
    T = read_wav(wav)[0].shape[0]
    for c in (1, 2):
        y, _ = read_wav(os.path.join(demo_dir, os.path.basename(wav).replace(
            ".wav", f"_s{c}.wav")))
        check(y.shape == (T,) and np.isfinite(y).all(),
              f"bad stream-demo output s{c}")
    print(f"the cLN package on the card: separate {n} utterances (launches "
          f"{sep_launches}, 1 batch each); separate --streaming 1 and "
          f"stream-demo wrote finite wavs; stream-demo {stats}", flush=True)
    return counts


def phase_streaming(torch, k, work: str, card: str):
    """The streaming separator on the card, f32, the paper widths with the
    causal cLN norm (random weights from seed 0): two seeded 4 s mixtures
    in chunks of 8 ms rounded down to whole hops (60 samples, 7.5 ms).
    The stream plus the flush against the offline causal forward on the
    input left-padded with L - hop zeros: the plain path within STREAM_TOL
    (the same math in another summation order), the kernel path within the
    forward's f32 bar 2e-3, with the pairs on (16 launches of the pair
    kernel B4) and off (32 of kernel 1), which give the same bits. The
    stream launches no kernel. Then ``stream_demo`` on one of the mixtures at
    8 ms: its per-chunk latencies and real-time factor (recorded, not
    gated), and its wav against the stream."""
    import numpy as np

    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
    from convtasnet_tpu_torch.infer.stream_demo import stream_demo
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet, init_params
    from convtasnet_tpu_torch.models.streaming import StreamingSeparator
    from convtasnet_tpu_torch.train.checkpoint import save_inference_package

    cfg = ConvTasNetConfig(norm_type="cLN", causal=True,
                           compute_dtype="float32")
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    hop, T = cfg.stride, SECONDS * SAMPLE_RATE
    chunk = int(0.008 * SAMPLE_RATE) // hop * hop
    Tp = -(-T // chunk) * chunk
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.zeros(2, Tp, device="cuda")
    x[:, :T] = 0.1 * torch.randn(2, T, generator=gen, device="cuda")

    sep = StreamingSeparator(cfg, sd, batch_size=2, device="cuda")
    tcn_reset(k)
    t0 = time.perf_counter()
    outs = [sep.process(x[:, s:s + chunk]) for s in range(0, Tp, chunk)]
    outs.append(sep.flush())
    stream = torch.cat(outs, dim=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tcn_counts(k) == tcn_want(),
          f"the stream launched {tcn_counts(k)}")
    pad = torch.nn.functional.pad(x, (cfg.kernel_size - hop, 0))
    offline = {}
    for path, flag, pairs, want in (
            ("plain", False, True, tcn_want()),
            ("kernel, pairs on", True, True, tcn_want(b4=16)),
            ("kernel, pairs off", True, False, tcn_want(b1=32))):
        model = ConvTasNet(cfg, use_pallas=flag, device="cuda")
        model.load_state_dict(sd)
        model.eval()
        tcn_reset(k)
        with torch.inference_mode(), pair_switch(pairs):
            offline[path] = model(pad)
        torch.cuda.synchronize()
        n = tcn_counts(k)
        check(n == want, f"offline {path} path: launches {n}, expected "
              f"{want}")
    check(stream.shape == offline["plain"].shape
          and torch.isfinite(stream).all().item(),
          f"stream {tuple(stream.shape)} vs offline "
          f"{tuple(offline['plain'].shape)}, or non-finite")
    errs = {path: rel_l2(stream, y) for path, y in offline.items()}
    same_bits = torch.equal(offline["kernel, pairs on"],
                            offline["kernel, pairs off"])
    print(f"stream [2 x {SECONDS} s] f32 cLN causal in {chunk}-sample "
          f"chunks ({Tp // chunk} steps, {wall:.2f} s wall): vs offline "
          f"plain rel_l2 {errs['plain']:.3e} (bar {STREAM_TOL:.0e}), vs "
          f"offline kernel path pairs on {errs['kernel, pairs on']:.3e}, "
          f"pairs off {errs['kernel, pairs off']:.3e} (bar "
          f"{TOL['float32']:.0e}); the two kernel paths the same bits "
          f"{same_bits}", flush=True)
    check(errs["plain"] <= STREAM_TOL,
          f"stream vs offline plain {errs['plain']:.3e}")
    for path in ("kernel, pairs on", "kernel, pairs off"):
        check(errs[path] <= TOL["float32"],
              f"stream vs offline {path} {errs[path]:.3e}")
    check(same_bits, "the offline kernel path differs with the pairs on "
          "and off")

    pkg = os.path.join(work, "cln_f32.pt")
    save_inference_package(pkg, cfg, sd)
    wav = os.path.join(work, "stream_mix.wav")
    write_wav(wav, x[0, :T].cpu().numpy(), SAMPLE_RATE)
    demo_dir = os.path.join(work, "demo_f32")
    stats = stream_demo(pkg, wav, chunk_ms=8.0, out_dir=demo_dir,
                        device="cuda")
    held = read_wav(wav)[0]
    sep = StreamingSeparator(cfg, sd, batch_size=1, device="cuda")
    xs = torch.zeros(1, Tp)
    xs[0, :T] = torch.from_numpy(held)
    want = torch.cat([sep.process(xs[:, s:s + chunk]).cpu()
                      for s in range(0, Tp, chunk)], dim=-1)[0, :, :T]
    y = torch.from_numpy(np.stack([read_wav(os.path.join(
        demo_dir, f"stream_mix_s{c}.wav"))[0] for c in (1, 2)]))
    lsb = 1.0 / 32768.0
    demo_err = (y - want.clamp(-1.0, 1.0 - lsb)).abs().max().item()
    print(f"timing [{card}] stream-demo paper widths cLN causal f32, "
          f"{SECONDS} s wav: {stats}; wav vs stream max_abs {demo_err:.3e} "
          f"(bar one PCM-16 step {lsb:.3e})", flush=True)
    check(demo_err <= lsb * 1.001, f"stream-demo wav off the stream by "
          f"{demo_err:.3e}")
    return stats


def train_batch(torch, M: int, seed: int):
    """A seeded [M, 4 s] training batch on the card."""
    T = SECONDS * SAMPLE_RATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(M, T, generator=g, device="cuda"),
            torch.full((M,), T, dtype=torch.int32, device="cuda"),
            torch.randn(M, 2, T, generator=g, device="cuda"),
            torch.ones(M, device="cuda"))


# the batch seeds of phase_step_compare, per separator
STEP_SEEDS = {"tcn": (11, 12), "dpt": (11, 12, 13)}
# a DPT bf16 step gate's per-seed ceiling, in units of the plain bf16
# path's distance from the f32 gradient, beside the median bar of 1.25:
# with B7's forward swapped for its own plain twin the DPT step reads up
# to 1.72 at one seed (PERF.md §6)
SEED_CEILING = 2.0


def phase_step_compare(torch, separator: str = "tcn", norm: str = "gLN",
                       conv_kernel: int = 3, seeds=None):
    """Loss and gradients of one train step, kernel path vs plain path,
    from the same init and batch, per batch seed (``STEP_SEEDS``: two
    for the TCN, three for the DPT), for the paper config (``separator``
    "tcn"), its causal cLN variant (``norm`` "cLN") or the DPT quality
    default ("dpt").

    At random init the paper model's gradient is ill-conditioned: in f32
    the plain path against itself with its sums reordered (gradients
    accumulated over 2-row chunks) moves by ~1.3e-3 globally and by 10% on
    the smallest scalar PReLU-slope gradients, and in bf16 either path is
    ~0.2 from the f32 gradient. Reordering cannot move a cLN model, whose
    statistics each span one row, so the plain path also runs on the
    mixture nudged by one or two f32 rounding steps, which shows how far
    the model carries a rounding difference. So in f32 the loss, the
    global gradient, the correlation of every multi-element leaf (the JAX
    whole-model test's criterion) and the slopes as one vector are held;
    in bf16 the loss, and the kernel path's distance from the f32 gradient
    against the plain bf16 path's own: per seed for the TCN, and for the
    DPT per seed within ``SEED_CEILING`` times the plain path's and by the
    medians over the seeds within max(8e-2, 1.25x): at random init each
    seed's distance is one draw of 1 / c of the least correlated
    (estimate, source) pair (PERF.md §6), which any change of a bf16
    rounding re-draws. The DPT model has no scalar leaves, and its
    kernel path launches each sublayer's backward kernel. The gLN model's
    kernel paths also include the tensor-parallel step over two shards on
    cuda:0 (``tp_loss_and_grads``: 64 B6 launches, no other TCN kernel),
    and the DPT's its tensor-parallel step over two shards (the partial
    kernels, 2 x (4, 4, 8) forward and backward launches, no full-mode
    one), held the same way. ``conv_kernel`` sets the model's depthwise
    taps P (``phase_tcn_taps``), ``seeds`` the batch seeds. Every reading
    is printed before the phase fails."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import (
        tp_loss_and_grads,
    )
    from convtasnet_tpu_torch.train import train_step as ts

    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra

    # the launch counters of the backward kernels of a DPT model; a TCN
    # kernel path, and the DPT's tensor-parallel one, are held to their
    # exact counts per step
    counters = [(f, "launches") for f in (
        dpt_attention.fused_inter_attention_bwd,
        dpt_intra.fused_intra_attention_bwd, dpt_ffn.fused_ffn_bwd)]
    dpt = {"inter": dpt_attention, "intra": dpt_intra, "ffn": dpt_ffn}
    mods = tcn_modules()
    # name -> (pairs, launches, tensor-parallel shards)
    if separator == "dpt":
        kernel_paths = {"kernel": (True, None, 1),
                        "kernel, TP m=2": (True, None, 2)}
    elif norm == "cLN":   # a cLN pair trains as two blocks, as in JAX
        kernel_paths = {"kernel": (True, tcn_want(b1=32, b3=32), 1)}
    else:
        kernel_paths = {
            "kernel": (True, tcn_want(b4=16, b5=16), 1),
            "kernel, pairs off": (False, tcn_want(b1=32, b2=32), 1),
            "kernel, TP m=2": (False, tcn_want(b6=64), 2)}
    failures = []
    label = separator if norm == "gLN" else f"{separator} {norm} causal"
    if conv_kernel != 3:
        label += f" P={conv_kernel}"
    dists = {kpath: [] for kpath in kernel_paths}   # the DPT's, bf16
    for seed in seeds or STEP_SEEDS[separator]:
        batch = train_batch(torch, 4, seed)
        # the mixture with most samples moved by one or two f32 rounding
        # steps: how far the model itself carries such a difference
        mix = batch[0]
        nudged = (mix + mix * 2.0 ** -23 * torch.randn(
            mix.shape, generator=torch.Generator(device="cuda")
            .manual_seed(seed), device="cuda"), *batch[1:])
        for dtype in ("float32", "bfloat16"):
            cfg = ConvTasNetConfig(separator=separator, compute_dtype=dtype,
                                   norm_type=norm, causal=norm == "cLN",
                                   conv_kernel=conv_kernel)
            sd = init_params(cfg, torch.Generator().manual_seed(0))
            res = {}
            runs = [(path, True, pairs, 0, batch, m) for path, (pairs, _, m)
                    in kernel_paths.items()]
            runs += [("plain", False, True, 0, batch, 1),
                     ("plain_c2", False, True, 2, batch, 1),
                     ("plain_ulp", False, True, 0, nudged, 1)]
            for path, flag, pairs, chunk, b, m in runs:
                state = ts.create_train_state(cfg, SolverConfig(),
                                              device="cuda", use_pallas=flag,
                                              state_dict=sd)
                if separator == "dpt":
                    reset_dpt_all(dpt)
                before = [getattr(f, a) for f, a in counters]
                tcn_reset(mods)
                with pair_switch(pairs):
                    loss = float(
                        tp_loss_and_grads(cfg, state.model, b,
                                          shard_devices(m, "cuda"))
                        if m > 1 else
                        ts._loss_and_grads(state.model, b, chunk))
                torch.cuda.synchronize()
                if flag and separator == "dpt" and m == 1 and not all(
                        getattr(f, a) > c for (f, a), c
                        in zip(counters, before)):
                    failures.append(f"{label} {dtype} kernel path "
                                    "launched no backward kernel")
                if flag and separator == "dpt" and m > 1:
                    want = dpt_partial_want(m, cfg.dpt_layers, 1, 1)
                    if dpt_partial_counts(dpt) != want:
                        failures.append(f"{label} {dtype} {path} launched "
                                        f"{dpt_partial_counts(dpt)}, "
                                        f"expected {want}")
                if flag and separator == "tcn":
                    want = kernel_paths[path][1]
                    if tcn_counts(mods) != want:
                        failures.append(f"{label} {dtype} {path} launched "
                                        f"{tcn_counts(mods)}, expected {want}")
                res[path] = (loss, {n: p.grad.detach().float().clone()
                                    for n, p in
                                    state.model.named_parameters()})
                del state
            (lp, gp), (_, gc), (_, gu) = (
                res[k] for k in ("plain", "plain_c2", "plain_ulp"))
            flat = {k: torch.cat([g.reshape(-1) for g in v.values()])
                    for k, (_, v) in res.items()}
            if not all(torch.isfinite(v).all().item() for v in flat.values()):
                failures.append(f"non-finite gradients ({dtype}, seed {seed})")
            if "kernel, pairs off" in kernel_paths:
                # the pairs run the singles' stages of their dtype and
                # widths: the same bits in bf16 and f32
                same = torch.equal(flat["kernel"], flat["kernel, pairs off"])
                apart = rel_l2(flat["kernel"], flat["kernel, pairs off"])
                print(f"train step {label} {dtype} seed {seed}: pairs on and "
                      f"off give the same gradient bits {same}, rel_l2 "
                      f"{apart:.3e}", flush=True)
                if not same:
                    failures.append(f"{label} {dtype} seed {seed}: the pairs' "
                                    f"gradient differs from the singles' "
                                    f"({apart:.3e})")
            for kpath in kernel_paths:
                lk, gk = res[kpath]
                loss_rel = abs(lk - lp) / abs(lp)
                global_err = rel_l2(flat[kpath], flat["plain"])
                head = (f"train step {label} {dtype} B=4x{SECONDS}s seed "
                        f"{seed} {kpath} "
                        f"vs plain: loss {lk:.6f} vs {lp:.6f} (rel "
                        f"{loss_rel:.3e}), global gradient rel_l2 "
                        f"{global_err:.3e} (plain vs itself reordered "
                        f"{rel_l2(flat['plain_c2'], flat['plain']):.3e}, with "
                        f"the mixture nudged by one rounding step "
                        f"{rel_l2(flat['plain_ulp'], flat['plain']):.3e})")
                at = f"{label} {dtype} seed {seed} {kpath}"
                if dtype == "float32":
                    f32_grads = flat["plain"]
                    multi = [n for n in gp if gp[n].numel() > 1]
                    corr = {n: torch.corrcoef(torch.stack(
                        [gk[n].reshape(-1), gp[n].reshape(-1)]))[0, 1].item()
                        for n in multi}
                    # NaN (a constant leaf) counts as no correlation
                    corr = {n: c if math.isfinite(c) else -1.0
                            for n, c in corr.items()}
                    low = min(corr, key=corr.get)
                    slopes = [n for n in gp if gp[n].numel() == 1]
                    slope_err = rel_l2(torch.stack([gk[n] for n in slopes]),
                                       torch.stack([gp[n] for n in slopes])) \
                        if slopes else 0.0
                    print(f"{head}; lowest leaf correlation {low} "
                          f"{corr[low]:.7f}; the {len(slopes)} slopes as one "
                          f"vector rel_l2 {slope_err:.3e}", flush=True)
                    if loss_rel > 1e-5:
                        failures.append(f"{at} loss off by {loss_rel:.3e}")
                    if global_err > BWD_TOL[dtype]:
                        failures.append(f"{at} global gradient off by "
                                        f"{global_err:.3e}")
                    if corr[low] < 0.9999:
                        failures.append(f"{at} gradient leaf {low} "
                                        f"correlation {corr[low]:.7f}")
                    if slope_err > BWD_TOL[dtype]:
                        failures.append(f"{at} slope gradients off by "
                                        f"{slope_err:.3e}")
                else:
                    k_f32 = rel_l2(flat[kpath], f32_grads)
                    p_f32 = rel_l2(flat["plain"], f32_grads)
                    if separator == "dpt":
                        dists[kpath].append((k_f32, p_f32))
                        bar = SEED_CEILING * p_f32
                    else:
                        bar = max(BWD_TOL[dtype], 1.25 * p_f32)
                    print(f"{head}; from the f32 gradient: kernel path "
                          f"{k_f32:.3e}, plain path {p_f32:.3e} (bar "
                          f"{bar:.3e})", flush=True)
                    if loss_rel > 4e-2:
                        failures.append(f"{at} loss off by {loss_rel:.3e}")
                    if k_f32 > bar:
                        failures.append(f"{at} kernel-path gradient "
                                        f"{k_f32:.3e} from the f32 one, plain "
                                        f"path {p_f32:.3e}")
    for kpath, pairs in dists.items() if separator == "dpt" else ():
        k_f32 = statistics.median(k for k, _ in pairs)
        p_f32 = statistics.median(p for _, p in pairs)
        bar = max(BWD_TOL["bfloat16"], 1.25 * p_f32)
        print(f"train step {label} bfloat16 {kpath}: kernel path {k_f32:.3e} "
              f"from the f32 gradient, plain path {p_f32:.3e} (medians of "
              f"{len(pairs)} seeds; bar {bar:.3e})", flush=True)
        if k_f32 > bar:
            failures.append(f"{label} bfloat16 {kpath} kernel-path gradient "
                            f"{k_f32:.3e} from the f32 one (median), plain "
                            f"path {p_f32:.3e}")
    check(not failures, "train step, kernel vs plain: " + "; ".join(failures))


# phase_tcn_taps: (P, dilation) of each kernel alone past the 16 taps of
# the TCN kernels' first routes; at P = 33, d = 128 the halo (4,096 rows)
# is longer than K = 3199, so most rows skip most taps
TAPS_CASES = [(17, 1), (17, 128), (33, 1), (33, 128)]
SLOPES = ("da1", "da2")


def taps_bwd_errors(torch, bwd, x, w, kw, seed: int):
    """B2 or B3 at a random cotangent against the exact f32 cotangents
    (the twin in f32 on the same values; f32 B3 against the f64 block,
    ``f64_nearest_branches``, whose note it prints): {name: rel_l2}."""
    g = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda").to(x.dtype)
    got = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
    if x.dtype == torch.float32 and kw["norm_type"] == "cLN":
        exact, _, note = f64_nearest_branches(
            torch, x, g, w, kw["dilation"], kw["causal"], "cLN", got,
            BWD_TOL["float32"])
        print(f"taps B3 P={w[1].shape[0]} d={kw['dilation']} f64 branches: "
              f"{note}", flush=True)
    else:
        exact = bwd.fused_tcn_block_bwd_reference(
            x.float(), g.float(), *[t.float() for t in w], **kw)
    return {n: rel_l2(q, r) for n, q, r in zip(GRAD_NAMES, got, exact)}


def taps_pair_bwd_errors(torch, pair_bwd, x, pa, pb, kw, seed: int):
    """B5 at a random cotangent against the exact f32 cotangents: dx and
    the 14 weight and affine gradients each, the four slopes as one
    vector ("slopes")."""
    g = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda").to(x.dtype)
    got = pair_grads(pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw))
    exact = pair_grads(pair_bwd.fused_tcn_block_pair_bwd_reference(
        x.float(), g.float(), [t.float() for t in pa],
        [t.float() for t in pb], **kw))
    q, r = dict(zip(PAIR_GRAD_NAMES, got)), dict(zip(PAIR_GRAD_NAMES, exact))
    slopes = [n for n in PAIR_GRAD_NAMES if n.startswith(SLOPES)]
    errs = {n: rel_l2(q[n], r[n]) for n in PAIR_GRAD_NAMES if n not in slopes}
    errs["slopes"] = rel_l2(torch.stack([q[n].reshape(()) for n in slopes]),
                            torch.stack([r[n].reshape(()) for n in slopes]))
    return errs


def taps_kernels_vs_twins(torch, k, failures: list) -> None:
    """Each TCN kernel alone at [8, 3199, 256], H = 512, P = 17 and 33 at
    d = 1 and 128 (``TAPS_CASES``), bf16 and f32: B1 in gLN (non-causal),
    cLN (causal) and BN (non-causal, running statistics) against its twin
    at the forward bars; B2 (gLN) and B3 (cLN causal) at a random
    cotangent against the exact f32 cotangents (f32 B3 against the f64
    block), ``phase_bwd_vs_twin``'s
    gate (all ten within 4e-3 in f32, the eight besides the PReLU slopes
    within 8e-2 in bf16); B4 and B5 at (d1, d2) = (64, 128), B4 at the
    pair gate and B5 at ``phase_pair_bwd_vs_twin``'s (the 15 besides the
    slopes within 8e-2 in bf16, all 19 within 4e-3 in f32, the slopes as
    one vector); B6 at Hs = 256 at the forward bars and at its rounding
    points (``TP_ORDER_TOL``). Then P = 16 causal (the old limit) through
    B1 and B2 (gLN) and B1 and B3 (cLN) at d = 1 and 128, and the bf16
    cLN B1 at P = 47, d = 128 on one sample of K = 6,000, whose C' halo of
    statistics (6,000 rows) does not fit beside its resident operands in
    shared memory."""
    tcn, bwd = k["tcn"], k["bwd"]
    pair, pair_bwd, tp = k["pair"], k["pair_bwd"], k["tp"]
    bn = tuple(torch.rand(512, generator=torch.Generator(device="cuda")
                          .manual_seed(5), device="cuda") + 0.5
               for _ in range(4))

    def fwd(name, label, got, want, bar):
        err = rel_l2(got, want)
        print(f"taps {label} {name}: rel_l2 {err:.3e} (bar {bar:.0e})",
              flush=True)
        if not (torch.isfinite(got).all().item() and err <= bar):
            failures.append(f"{label} {name}: {err:.3e}")

    def bwd_gate(name, label, errs):
        held = {n: v for n, v in errs.items()
                if name == "float32" or n not in SLOPES + ("slopes",)}
        top = max(held, key=held.get)
        print(f"taps {label} {name}: random g vs exact, held {held[top]:.3e} "
              f"({top}; bar {BWD_TOL[name]:.0e}), dx {errs['dx']:.3e}, "
              f"slopes " + " ".join(f"{n} {errs[n]:.2e}" for n in errs
                                    if n in SLOPES + ("slopes",)), flush=True)
        if held[top] > BWD_TOL[name]:
            failures.append(f"{label} {name}: {top} {held[top]:.3e}")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        cases = [(P, d, norms) for P, d in TAPS_CASES
                 for norms in (("gLN", False), ("cLN", True), ("BN", False))]
        cases += [(16, d, norms) for d in (1, 128)
                  for norms in (("gLN", True), ("cLN", True))]
        for P, d, (norm, causal) in cases:
            x, *w = block_inputs(torch, dtype, 300 + P + d, P=P, a2=-0.1)
            kw = dict(dilation=d, causal=causal, norm_type=norm)
            bkw = dict(kw, bn_stats=bn) if norm == "BN" else kw
            label = (f"[8,3199,256] H=512 P={P} d={d} {norm} causal="
                     f"{int(causal)}")
            with torch.inference_mode():
                got = tcn.fused_tcn_block(x, *w, **bkw)
                want = tcn.fused_tcn_block_reference(x, *w, **bkw)
            fwd(name, f"B1 {label}", got, want, TOL[name])
            if norm != "BN":
                bwd_gate(name, f"B{2 if norm == 'gLN' else 3} {label}",
                         taps_bwd_errors(torch, bwd, x, w, kw, 400 + P + d))
        for P, _ in TAPS_CASES[::2]:
            x, *pa = block_inputs(torch, dtype, 500 + P, P=P)
            _, *pb = block_inputs(torch, dtype, 600 + P, P=P, a2=-0.1)
            kw = dict(d1=64, d2=128, causal=False)
            label = f"[8,3199,256] H=512 P={P} d=(64,128) gLN"
            with torch.inference_mode():
                got = pair.fused_tcn_block_pair(x, pa, pb, norm_type="gLN",
                                                **kw)
                want = pair.fused_tcn_block_pair_reference(
                    x, pa, pb, norm_type="gLN", **kw)
            fwd(name, f"B4 {label}", got, want, PAIR_TOL[name])
            bwd_gate(name, f"B5 {label}",
                     taps_pair_bwd_errors(torch, pair_bwd, x, pa, pb, kw,
                                          700 + P))
        for P, d in TAPS_CASES:
            args = tp_stage2_inputs(torch, dtype, 256, 800 + P + d, P=P)
            kw = dict(dilation=d, causal=False)
            label = f"B6 [8,3199,256] P={P} d={d}"
            with torch.inference_mode():
                z, sums = tp.fused_tp_stage2(*args, **kw)
                z_want, s_want = tp.tp_stage2_reference(*args, **kw)
                z_ord, s_ord = tp.tp_stage2_reference(*args, **kw,
                                                      rounding="pallas")
            fwd(name, f"{label} z", z, z_want, TOL[name])
            fwd(name, f"{label} sums", sums, s_want, TOL[name])
            fwd(name, f"{label} z at its rounding points", z, z_ord,
                TP_ORDER_TOL[name])
    x, *w = block_inputs(torch, torch.bfloat16, 47, M=1, K=6000, P=47)
    kw = dict(dilation=128, causal=True, norm_type="cLN")
    with torch.inference_mode():
        got = tcn.fused_tcn_block(x, *w, **kw)
        want = tcn.fused_tcn_block_reference(x, *w, **kw)
    fwd("bfloat16", "B1 [1,6000,256] H=512 P=47 d=128 cLN causal=1 (C' "
        "halo statistics from device memory)", got, want, TOL["bfloat16"])


def taps_zero_taps_same_bits(torch, k, failures: list) -> None:
    """The routes past 16 taps against the first routes, bit for bit: a
    block of P = 17 taps whose extra taps are zero (tap 0 causal, taps 0
    and 16 otherwise, so that every other tap reads the rows it reads at
    P = 16 or 15) sums the same products in the same order as the block
    of 16 (causal) or 15 taps on the first routes, so B1 (gLN, cLN, BN),
    B2, B3, B5 and B6 give the same bits, d_dw's extra rows aside; at the
    paper shape, d = 4, bf16 and f32."""
    tcn, bwd, pair_bwd, tp = k["tcn"], k["bwd"], k["pair_bwd"], k["tp"]

    def widen(dw, causal):
        zero = torch.zeros_like(dw[:1])
        return torch.cat([zero, dw] + ([] if causal else [zero]))

    def same(label, a, b):
        ok = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"taps P=17 with zero taps vs the first route, {label}: same "
              f"bits {ok}", flush=True)
        if not ok:
            failures.append(f"P=17 with zero taps differs from the first "
                            f"route: {label}")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for norm, causal in (("gLN", False), ("cLN", True), ("BN", False),
                             ("gLN", True)):
            P = 16 if causal else 15
            x, *w = block_inputs(torch, dtype, 900 + P, P=P, a2=-0.1)
            w17 = list(w)
            w17[1] = widen(w[1], causal)
            kw = dict(dilation=4, causal=causal, norm_type=norm)
            if norm == "BN":
                kw["bn_stats"] = tuple(torch.ones(512, device="cuda")
                                       for _ in range(4))
            with torch.inference_mode():
                a = tcn.fused_tcn_block(x, *w, **kw)
                b = tcn.fused_tcn_block(x, *w17, **kw)
            label = f"{name} {norm} causal={int(causal)}"
            same(f"B1 {label}", [a], [b])
            if norm == "BN":
                continue
            g = torch.randn(x.shape, generator=torch.Generator(
                device="cuda").manual_seed(P), device="cuda").to(dtype)
            ga = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
            gb = list(bwd.fused_tcn_block_bwd(x, g, *w17, **kw))
            gb[2] = gb[2][1:1 + P]   # d_dw of the taps both blocks have
            same(f"B{2 if norm == 'gLN' else 3} {label}", ga, gb)
        x, *pa = block_inputs(torch, dtype, 915, P=15)
        _, *pb = block_inputs(torch, dtype, 916, P=15, a2=-0.1)
        pa17, pb17 = list(pa), list(pb)
        pa17[1], pb17[1] = widen(pa[1], False), widen(pb[1], False)
        g = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(15), device="cuda").to(dtype)
        kw = dict(d1=4, d2=8, causal=False)
        a = pair_grads(pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw))
        b = list(pair_grads(pair_bwd.fused_tcn_block_pair_bwd(
            x, g, pa17, pb17, **kw)))
        for i in (2, 11):   # d_dw of blocks a and b
            b[i] = b[i][1:16]
        same(f"B5 {name} gLN", a, b)
        args = list(tp_stage2_inputs(torch, dtype, 256, 15, P=15))
        args17 = list(args)
        args17[2] = widen(args[2], False)
        with torch.inference_mode():
            a = tp.fused_tp_stage2(*args, dilation=4, causal=False)
            b = tp.fused_tp_stage2(*args17, dilation=4, causal=False)
        same(f"B6 {name} Hs=256", a, b)


def taps_serve(torch, k, failures: list) -> None:
    """The paper config at P = 17 served at B = 8 x 4 s in bf16 and f32
    through the kernels against the plain path at the forward bars, with
    exact launch counts: gLN with pairs off (32 B1) and on (16 B4), cLN
    causal (32 B1, pairs off), and gLN over two shards (``tp_forward``:
    32 x 2 B6)."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(17), device="cuda")
    for dtype in ("bfloat16", "float32"):
        for norm in ("gLN", "cLN"):
            cfg = ConvTasNetConfig(compute_dtype=dtype, conv_kernel=17,
                                   norm_type=norm, causal=norm == "cLN")
            n = cfg.num_blocks * cfg.num_repeats
            kernel = ConvTasNet(cfg, device="cuda").eval()
            plain = ConvTasNet(cfg, use_pallas=False, device="cuda").eval()
            plain.load_state_dict(kernel.state_dict())
            with torch.inference_mode():
                want = plain(mix)
                paths = [("pairs off", False, tcn_want(b1=n))]
                if norm == "gLN":
                    paths += [("pairs on", True, tcn_want(b4=n // 2)),
                              ("two shards", False, tcn_want(b6=2 * n))]
                for path, pairs, launches in paths:
                    tcn_reset(k)
                    with pair_switch(pairs):
                        got = (tp_forward(cfg, kernel.state_dict(), mix,
                                          shard_devices(2, "cuda"))
                               if path == "two shards" else kernel(mix))
                    torch.cuda.synchronize()
                    counts, err = tcn_counts(k), rel_l2(got, want)
                    print(f"taps serve paper config P=17 {norm} causal="
                          f"{int(cfg.causal)} {dtype} B=8x{SECONDS}s {path}: "
                          f"vs plain rel_l2 {err:.3e} (bar {TOL[dtype]:.0e});"
                          f" launches {counts}", flush=True)
                    if counts != launches:
                        failures.append(f"serve P=17 {norm} {dtype} {path} "
                                        f"launched {counts}, expected "
                                        f"{launches}")
                    if not (torch.isfinite(got).all().item()
                            and err <= TOL[dtype]):
                        failures.append(f"serve P=17 {norm} {dtype} {path}: "
                                        f"{err:.3e}")
            del kernel, plain


def phase_tcn_taps(torch, k):
    """TCN blocks with more than 16 depthwise taps, which the JAX package
    runs (any P causal, any odd P otherwise) and the kernels take past
    the 16 taps of their first routes: each kernel alone against its twin
    (``taps_kernels_vs_twins``), the routes past 16 taps against the
    first routes bit for bit (``taps_zero_taps_same_bits``), the paper
    config at P = 17 served (``taps_serve``) and one train step, kernel
    paths against the plain path at ``phase_step_compare``'s gates (batch
    seed 11): gLN with pairs on (16 B4, 16 B5) and off (32 B1, 32 B2) and
    over two shards (64 B6), and cLN causal (32 B1, 32 B3), launches
    exact. Every reading is printed before the phase fails."""
    t0 = time.perf_counter()
    failures = []
    taps_kernels_vs_twins(torch, k, failures)
    taps_zero_taps_same_bits(torch, k, failures)
    taps_serve(torch, k, failures)
    check(not failures, "TCN at more than 16 taps: " + "; ".join(failures))
    phase_step_compare(torch, "tcn", conv_kernel=17, seeds=(11,))
    phase_step_compare(torch, "tcn", "cLN", conv_kernel=17, seeds=(11,))
    print(f"tcn taps phase: {time.perf_counter() - t0:.1f} s", flush=True)


def f64_block(torch, args, dilation: int, causal: bool, norm: str,
              bn_stats=None, flips=None, pre=None):
    """One block's output with every product and statistic in float64
    (the block's math on float64 tensors): the witness of how close an f32
    evaluation comes to the value. flips: {"hp" or "c": flat indices} of
    pre-activations (h_pre = x @ W_in, c the depthwise conv's output) each
    taken to the other PReLU branch than its sign gives; pre, a dict, gets
    both pre-activations. The math is the dtype of args."""
    from convtasnet_tpu_torch.ops.conv import depthwise_conv1d
    from convtasnet_tpu_torch.ops.norm import (
        batch_norm,
        channelwise_layer_norm,
        global_layer_norm,
    )

    x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2 = args
    m1, v1, m2, v2 = bn_stats if norm == "BN" else (None,) * 4
    flips = flips or {}

    def nrm(h, g, b, m, v):
        if norm == "gLN":
            return global_layer_norm(h, g, b)
        if norm == "cLN":
            return channelwise_layer_norm(h, g, b)
        return batch_norm(h, g, b, m.double(), v.double())

    def prelu(v, a, name):
        if pre is not None:
            pre[name] = v.detach()
        keep = v >= 0
        if flips.get(name):
            keep = keep.reshape(-1).clone()
            keep[flips[name]] = ~keep[flips[name]]
            keep = keep.reshape(v.shape)
        return torch.where(keep, v, a * v)

    h = nrm(prelu(x @ w_in, a1, "hp"), g1, b1, m1, v1)
    h = nrm(prelu(depthwise_conv1d(h, dw, dilation, causal), a2, "c"), g2, b2,
            m2, v2)
    return x + h @ w_out


def f64_block_grads(torch, x, g, w, dilation: int, causal: bool,
                    norm: str, flips=None) -> tuple:
    """The ten cotangents of the f64 block (autograd through ``f64_block``
    on float64 copies of x and the nine weights, its flips taken) at the
    cotangent g."""
    prims = [t.detach().double().requires_grad_(True) for t in (x, *w)]
    with torch.enable_grad():
        out = f64_block(torch, prims, dilation, causal, norm, flips=flips)
        return torch.autograd.grad(out, prims, g.double())


# f64_nearest_branches: a pre-activation lies within f32 rounding of 0
# where its f64 value is within NEAR_ZERO_ROUNDINGS times its row's rms
# rounding error of an f32 evaluation (the block's math in f32 against
# f64); the NEAR_ZERO_MOST nearest of them are tried
NEAR_ZERO_ROUNDINGS = 4.0
NEAR_ZERO_MOST = 10


def f64_nearest_branches(torch, x, g, w, dilation: int, causal: bool,
                         norm: str, got, bar: float,
                         roundings: float = NEAR_ZERO_ROUNDINGS,
                         most: int = NEAR_ZERO_MOST):
    """The f64 block's ten cotangents under the PReLU branch assignment of
    the pre-activations within f32 rounding of 0 that puts got's two slope
    gradients nearest: an f32 evaluation may take such an element to the
    other branch, and one flipped element of c moves da1 by ~2% at the
    paper shape (a slope gradient is a sum of millions of cancelling
    terms). Each candidate's effect on (da1, da2) comes from one f64
    evaluation with that element flipped alone; the subsets are summed
    from those, the smallest one that brings both slopes within bar of
    got's (else the nearest) is taken, and its cotangents are evaluated
    exactly. Returns (cotangents, the unflipped f64 cotangents, a note
    with the number of elements within rounding and each one tried)."""
    import itertools

    base = f64_block_grads(torch, x, g, w, dilation, causal, norm)
    args, pre64, pre32 = [x, *w], {}, {}
    with torch.no_grad():
        f64_block(torch, [t.double() for t in args], dilation, causal, norm,
                  pre=pre64)
        f64_block(torch, [t.float() for t in args], dilation, causal, norm,
                  pre=pre32)
    near = []   # (|v| in roundings, name, flat index)
    for name in ("hp", "c"):
        v = pre64[name]
        scale = (pre32[name].double() - v).square().mean(-1, keepdim=True)
        ratio = (v.abs() / scale.sqrt()).reshape(-1)
        idx = (ratio <= roundings).nonzero().reshape(-1)
        near += zip(ratio[idx].tolist(), [name] * len(idx), idx.tolist())
    near.sort()
    counts = {n: sum(1 for _, m, _ in near if m == n) for n in ("hp", "c")}
    tried = near[:most]

    def slopes(grads):
        return [grads[4].item(), grads[5].item()]

    b, k = slopes(base), slopes(got)
    deltas = [[s - t for s, t in zip(slopes(f64_block_grads(
        torch, x, g, w, dilation, causal, norm, {name: [i]})), b)]
        for _, name, i in tried]

    def worst(sel):
        v = [b[j] + sum(deltas[n][j] for n in sel) for j in range(2)]
        return max(abs(k[j] - v[j]) / max(abs(v[j]), 1e-30)
                   for j in range(2))

    subsets = [sel for r in range(len(tried) + 1)
               for sel in itertools.combinations(range(len(tried)), r)]
    best = min(subsets, key=lambda sel: (worst(sel) > bar, len(sel),
                                         worst(sel)))
    note = (f"{len(near)} pre-activations within {roundings:g} roundings of "
            f"0 (h_pre {counts['hp']}, c {counts['c']}), {len(best)} of the "
            f"{len(tried)} tried flipped")
    K, H = pre64["c"].shape[1:]
    for n, (r, name, i) in enumerate(tried):
        v = pre64[name].reshape(-1)[i].item()
        note += (f"; {name}[{i // (K * H)},{i // H % K},{i % H}] {v:.2e} "
                 f"({r:.2f} roundings) da1 {deltas[n][0]:+.4g} da2 "
                 f"{deltas[n][1]:+.4g}{' flipped' if n in best else ''}")
    if not best:
        return base, base, note
    flips = {}
    for n in best:
        flips.setdefault(tried[n][1], []).append(tried[n][2])
    return (f64_block_grads(torch, x, g, w, dilation, causal, norm, flips),
            base, note)


# the f32 stages' cases (csrc/tcn_block_tf32.cuh, tcn_block_bwd_tf32.cuh):
# (label, block_inputs keywords, dilations per norm) at the paper shape,
# at 17 taps (the routes past 16), at B = H = 96 (run padded to 128, the
# norms over 96) and at H = 64
F32_STAGE_CASES = [
    ("[8,3199,256] H=512", {}, {"gLN": (1, 16, 128), "cLN": (1, 16, 128),
                                "BN": (1, 128)}),
    ("P=17", dict(P=17), {"gLN": (4,), "cLN": (2,), "BN": (1,)}),
    ("B=H=96", dict(B=96, H=96), {"gLN": (8,), "cLN": (1,)}),
    ("H=64", dict(H=64), {"gLN": (2,), "cLN": (32,), "BN": (1,)}),
]
# the forward's out - x against the f64 block: 3xTF32 products are
# f32-grade, where one TF32 product (10 mantissa bits) reads ~3e-4
F32_ACCURACY_BAR = 1e-5


def phase_tcn_f32_stages(torch, k):
    """The f32 TCN stages on the 3xTF32 core: the core alone at B1's two
    product shapes against the f64 product (within 1e-6; torch.matmul in
    f32 printed beside it) with its split's rounding held against
    cvt.rna.tf32.f32 bit for bit; then B1 under gLN, cLN (causal) and BN,
    B2 and B3 (cLN, causal), at ``F32_STAGE_CASES``: each call against its
    twin at the f32 bars (2e-3 forward; 4e-3 backward on all ten
    cotangents of a random cotangent, the twin evaluated in f32; B3
    against the f64 block at that bar, the f32 twin printed), the
    forward's out - x within ``F32_ACCURACY_BAR`` of the f64 block, each
    kernel twice to the same bits, and one launch of its counter a call
    and none of any other TCN kernel's. At the paper shape, d = 1, the ten
    B2 and B3 cotangents' distances from the f64 block are printed beside
    the twin's. Every reading is printed before the phase fails."""
    t0 = time.perf_counter()
    tcn, bwd = k["tcn"], k["bwd"]
    failures = []
    from convtasnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    gen = torch.Generator(device="cuda").manual_seed(25)
    for rows, depth, cols in ((25592, 256, 512), (25592, 512, 256)):
        # the core alone at B1's two product shapes (ctn_tf32_matmul_check:
        # b as the stages take a weight, [cols, depth] K-major)
        a = torch.randn(rows, depth, device="cuda", generator=gen)
        b = torch.randn(cols, depth, device="cuda", generator=gen)
        ws = torch.empty(3 * cols * depth, device="cuda")
        c = torch.empty(rows, cols, device="cuda")
        err = lib.ctn_tf32_matmul_check(
            a.data_ptr(), b.data_ptr(), ws.data_ptr(), c.data_ptr(), rows,
            cols, depth, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        exact = a.double() @ b.double().t()
        core, f32 = rel_l2(c.double(), exact), rel_l2(a @ b.t(), exact)
        n = cols * depth
        rna = torch.equal(ws[:n].view(torch.int32),
                          ws[2 * n:].view(torch.int32))
        print(f"f32 stages core [{rows},{depth}]x[{depth},{cols}]: from "
              f"f64 {core:.3e} (torch.matmul f32 {f32:.3e}), the split's "
              f"rounding the bits of cvt.rna.tf32.f32 {rna}", flush=True)
        if err or not (core <= 1e-6 and rna):
            failures.append(f"core [{rows},{depth}]x[{depth},{cols}]: err "
                            f"{err}, {core:.3e}, rna bits {rna}")

    def launched(want: dict, what: str):
        got = tcn_counts(k)
        if got != tcn_want(**want):
            failures.append(f"{what}: launches {got}")

    for label, kw_in, dils in F32_STAGE_CASES:
        for norm, ds in dils.items():
            causal = norm == "cLN"
            for d in ds:
                args = block_inputs(torch, torch.float32, 700 + d, **kw_in)
                H = args[1].shape[1]
                bn = (tuple(torch.rand(H, device="cuda") + 0.5
                            for _ in range(4)) if norm == "BN" else None)
                kw = dict(dilation=d, causal=causal, norm_type=norm,
                          bn_stats=bn)
                tcn_reset(k)
                with torch.inference_mode():
                    got = tcn.fused_tcn_block(*args, **kw)
                    again = tcn.fused_tcn_block(*args, **kw)
                    torch.cuda.synchronize()
                    launched({"b1": 2}, f"B1 f32 {label} {norm} d={d}")
                    want = tcn.fused_tcn_block_reference(*args, **kw)
                    x64 = args[0].double()
                    exact = f64_block(torch, [t.double() for t in args], d,
                                      causal, norm, bn) - x64
                err = rel_l2(got, want)
                acc = rel_l2(got.double() - x64, exact)
                twin_acc = rel_l2(want.double() - x64, exact)
                same = torch.equal(got, again)
                print(f"f32 stages B1 {label} {norm} causal={int(causal)} "
                      f"d={d}: vs twin {err:.3e} (bar 2e-3), out - x vs f64 "
                      f"{acc:.3e} (bar {F32_ACCURACY_BAR:.0e}; the twin "
                      f"{twin_acc:.3e}), twice the same bits {same}",
                      flush=True)
                if not (err <= TOL["float32"] and acc <= F32_ACCURACY_BAR
                        and same and torch.isfinite(got).all().item()):
                    failures.append(f"B1 {label} {norm} d={d}: {err:.3e}, "
                                    f"{acc:.3e}, same bits {same}")
            if norm == "BN":
                continue
            # the backward: B2 (gLN) or B3 (cLN, causal)
            kern = "b2" if norm == "gLN" else "b3"
            for d in ds:
                a2 = -0.1 if d == 16 else 0.25   # one negative second slope
                if norm == "cLN":
                    a2 = -0.2 if d == 16 else 0.3
                x, *w = block_inputs(torch, torch.float32, 800 + d, a2=a2,
                                     **kw_in)
                g = torch.randn(x.shape, generator=torch.Generator(
                    device="cuda").manual_seed(3000 + d), device="cuda")
                kw = dict(dilation=d, causal=causal, norm_type=norm)
                tcn_reset(k)
                got = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
                again = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
                torch.cuda.synchronize()
                launched({kern: 2}, f"{kern.upper()} f32 {label} d={d}")
                want = bwd.fused_tcn_block_bwd_reference(x, g, *w, **kw)
                exact = base = None
                note = ""
                if kern == "b3":
                    exact, base, branches = f64_nearest_branches(
                        torch, x, g, w, d, causal, norm, got,
                        BWD_TOL["float32"])
                    twin_f64 = max(rel_l2(q, r) for q, r in zip(want, base))
                    to_twin = max(rel_l2(q, r) for q, r in zip(got, want))
                    note = (f"; the f32 twin from f64 {twin_f64:.3e}, the "
                            f"kernel from the twin {to_twin:.3e}; f64 "
                            f"branches: {branches}")
                elif label.startswith("[8,3199") and d == 1:
                    exact = base = f64_block_grads(torch, x, g, w, d, causal,
                                                   norm)
                # B2 against the f32 twin, B3 against the f64 block
                ref = exact if kern == "b3" else want
                errs = {n: rel_l2(q, r)
                        for n, q, r in zip(GRAD_NAMES, got, ref)}
                worst = max(errs, key=errs.get)
                same = all(torch.equal(u, v) for u, v in zip(got, again))
                print(f"f32 stages {kern.upper()} {label} {norm} "
                      f"causal={int(causal)} d={d} a2={a2}: vs "
                      f"{'f64 block' if kern == 'b3' else 'twin'} "
                      f"{errs[worst]:.3e} ({worst}; bar 4e-3{note}), twice "
                      f"the same bits {same}", flush=True)
                if not (errs[worst] <= BWD_TOL["float32"] and same and all(
                        torch.isfinite(q).all().item() for q in got)):
                    failures.append(f"{kern.upper()} {label} d={d}: "
                                    f"{errs[worst]:.3e} ({worst}), same "
                                    f"bits {same}")
                if label.startswith("[8,3199") and d == 1:
                    print(f"f32 stages {kern.upper()} [8,3199,256] H=512 "
                          f"{norm} causal={int(causal)} d=1, distance from "
                          "the f64 block: kernel " + ", ".join(
                              f"{n} {rel_l2(q, r):.2e}" for n, q, r in
                              zip(GRAD_NAMES, got, exact)) + "; twin "
                          + ", ".join(f"{n} {rel_l2(q, r):.2e}" for n, q, r
                                      in zip(GRAD_NAMES, want, base)),
                          flush=True)
    print(f"f32 stages phase: {time.perf_counter() - t0:.1f} s", flush=True)
    check(not failures, "f32 TCN stages: " + "; ".join(failures))


def phase_main_path(torch, k, work: str):
    import numpy as np

    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
    from convtasnet_tpu_torch.infer.separate import separate
    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.train.checkpoint import save_inference_package

    n_mix, batch_size = 4, 4
    T = SECONDS * SAMPLE_RATE
    mix_dir = os.path.join(work, "mix")
    os.makedirs(mix_dir)
    rng = np.random.default_rng(0)
    t = np.arange(T) / SAMPLE_RATE
    for i in range(n_mix):
        # two "speakers": amplitude-modulated tones plus noise
        s1 = np.sin(2 * np.pi * (200 + 50 * i) * t) * (1 + np.sin(3 * t))
        s2 = rng.standard_normal(T) * (1 + np.cos(2 * t + i))
        write_wav(os.path.join(mix_dir, f"utt{i}.wav"),
                  (0.2 * s1 + 0.1 * s2).astype(np.float32), SAMPLE_RATE)

    n_batches = -(-n_mix // batch_size)
    for dtype in ("bfloat16", "float32"):
        cfg = ConvTasNetConfig(compute_dtype=dtype)
        n_blocks = cfg.num_repeats * cfg.num_blocks
        pkg = os.path.join(work, f"paper_{dtype}.pt")
        save_inference_package(
            pkg, cfg, init_params(cfg, torch.Generator().manual_seed(0)))
        outs = {}
        # pairs on: blocks (x, x+1) through the pair kernel, 16 per batch;
        # pairs off: kernel 1 per block, 32 per batch
        for path, use_kernel, pairs, want in (
                ("kernel", True, True,
                 tcn_want(b4=n_blocks // 2 * n_batches)),
                ("kernel, pairs off", True, False,
                 tcn_want(b1=n_blocks * n_batches)),
                ("plain", False, True, tcn_want())):
            out_dir = os.path.join(work, f"out_{dtype}_{path}")
            tcn_reset(k)
            with pair_switch(pairs):
                n = separate(pkg, out_dir, mix_dir=mix_dir,
                             batch_size=batch_size,
                             use_pallas=None if use_kernel else False,
                             device="cuda")
            torch.cuda.synchronize()
            count = tcn_counts(k)
            check(count == want, f"separate {dtype} {path}: launches {count}, "
                  f"expected {want}")
            files = sorted(os.listdir(out_dir))
            wavs = [f for f in files if f.endswith(".wav")]
            check(n == n_mix and len(wavs) == n_mix * (1 + cfg.num_speakers),
                  f"{path} {dtype}: {n} utterances, {len(wavs)} wavs")
            est = []
            for f in wavs:
                y, sr = read_wav(os.path.join(out_dir, f))
                check(sr == SAMPLE_RATE and y.shape == (T,)
                      and np.isfinite(y).all(), f"{path} {dtype}: bad {f}")
                if "_s" in f:
                    est.append(y)
            outs[path] = torch.from_numpy(np.stack(est))
            print(f"separate {dtype} {path}: {n} utterances, {len(wavs)} "
                  f"wavs of {T} samples, launches {count} "
                  f"({n_batches} batch)", flush=True)
        for path in ("kernel", "kernel, pairs off"):
            err = rel_l2(outs[path], outs["plain"])
            print(f"separate {dtype}: {path} path vs plain path rel_l2 "
                  f"{err:.3e} (bar {TOL[dtype]:.0e})", flush=True)
            check(err <= TOL[dtype], f"separated outputs disagree ({dtype}, "
                  f"{path}): {err:.3e}")
        # the pairs run the singles' stages of their dtype and widths: the
        # same bits in bf16 and f32
        apart = rel_l2(outs["kernel"], outs["kernel, pairs off"])
        same = torch.equal(outs["kernel"], outs["kernel, pairs off"])
        print(f"separate {dtype}: pairs on vs off rel_l2 {apart:.3e}, the "
              f"same bits {same}", flush=True)
        check(same, f"separate {dtype}: the pairs and the single blocks "
              f"differ ({apart:.3e})")


DPT_S, DPT_B, DPT_F, DPT_HEADS = 128, 256, 1024, 8   # the DPT quality default
# (n chunks, real frames K): one chunk of which 100 frames are real, the
# B=8 x 4 s main shape (K=3199), and a 15 s utterance (K=11999)
DPT_SHAPES = ((1, 100), (25, 3199), (94, 11999))
DPT_KINDS = ("inter", "intra", "ffn")


def dpt_inputs(torch, kind: str, dtype, n: int, K: int, seed: int, M=8,
               S=DPT_S, x_scale=1.0, heads=DPT_HEADS, B=DPT_B, F=DPT_F):
    """Seeded operands of one DPT sublayer on the card at the quality
    default's widths (or width B, hidden width F; ``heads`` heads), with
    the key mask of K real frames out of n*S, and x of standard deviation
    x_scale: (args, kwargs, valid [n, S])."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    valid = torch.arange(n * S, device="cuda").reshape(n, S) < K
    x = rn(M, n, S, B, scale=x_scale).to(dtype)
    gamma, beta = 1.0 + 0.1 * rn(B), 0.1 * rn(B)
    if kind == "ffn":
        args = (x.reshape(M, n * S, B), gamma, beta,
                rn(B, F, scale=B ** -0.5).to(dtype), 0.1 * rn(F),
                rn(F, B, scale=F ** -0.5).to(dtype), 0.1 * rn(B))
        return args, {}, valid
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32)
    args = (x, gamma, beta, rn(B, 3 * B, scale=B ** -0.5).to(dtype),
            rn(B, B, scale=B ** -0.5).to(dtype), bias)
    return args, dict(n_heads=heads), valid


def dpt_fns(dpt, kind: str):
    """(kernel wrapper, plain twin) of one DPT sublayer."""
    return {"inter": (dpt["inter"].fused_inter_attention,
                      dpt["inter"].inter_attention_reference),
            "intra": (dpt["intra"].fused_intra_attention,
                      dpt["intra"].intra_attention_reference),
            "ffn": (dpt["ffn"].fused_ffn, dpt["ffn"].ffn_reference)}[kind]


def rounded_forward(dpt, kind: str, args, kw):
    """A DPT sublayer forward at the rounding points of its bf16 kernel:
    the FFN's bf16 twin rounds where B11 rounds; the attention's rounds
    the scores too, so ``attention_rounded_reference`` (products in f32,
    rounded once: qkv, round(p), a, the out product) over chunks (B7) or
    within them (B9)."""
    if kind == "ffn":
        return dpt["ffn"].ffn_reference(*args, **kw)
    return dpt["inter"].attention_rounded_reference(
        *args, attend_axis=1 if kind == "inter" else 2, **kw)


# rows of standard deviation 0.0316 (variance ~1e-3): there an LN eps of
# 1e-5 put for 1e-6 moves the normalised rows by ~4.5e-3, where at unit
# variance it moves them by 4.5e-6, under the f32 bar
LOW_VAR_SCALE = 0.0316


def phase_dpt_kernels_vs_twin(torch, dpt):
    """Each DPT sublayer kernel against its plain twin at the quality
    default's widths ([8, n, 128, 256], 8 heads, F=1024) with the real key
    mask, for n = 1, 25 and 94, bf16 and f32, and in f32 at n = 25 with
    rows of variance ~1e-3 (which an LN eps off by 10x moves by ~4.5e-3):
    rel-L2 on the valid rows within 4e-2 / 1e-5; the bf16 kernels (their
    Hopper designs) also within 1e-3 of the forward at their rounding
    points (``rounded_forward``). Every case is printed before the phase
    fails; returns the worst max_abs_err per kernel."""
    worst = {k: 0.0 for k in DPT_KINDS}
    failures = []
    for kind in DPT_KINDS:
        fused, twin = dpt_fns(dpt, kind)
        for dtype, x_scale in ((torch.bfloat16, 1.0), (torch.float32, 1.0),
                               (torch.float32, LOW_VAR_SCALE)):
            name = str(dtype).split(".")[-1]
            shapes = DPT_SHAPES if x_scale == 1.0 else ((25, 3199),)
            for n, K in shapes:
                args, kw, valid = dpt_inputs(torch, kind, dtype, n, K,
                                             seed=3000 + n, x_scale=x_scale)
                got = fused(*args, **kw)
                torch.cuda.synchronize()
                want = twin(*args, **kw)
                torch.cuda.synchronize()
                rows = valid.reshape(-1)
                got_v = got.reshape(8, n * DPT_S, DPT_B)[:, rows]
                want_v = want.reshape(8, n * DPT_S, DPT_B)[:, rows]
                err = rel_l2(got_v, want_v)
                abs_err = (got_v.float() - want_v.float()).abs().max().item()
                worst[kind] = max(worst[kind], abs_err)
                finite = torch.isfinite(got_v).all().item()
                at, order = "", 0.0
                if dtype == torch.bfloat16:
                    rounded = rounded_forward(dpt, kind, args, kw)
                    order = rel_l2(got_v, rounded.reshape(
                        8, n * DPT_S, DPT_B)[:, rows])
                    at = (f", at its rounding points {order:.3e} (bar "
                          f"{TP_ORDER_TOL[name]:.0e})")
                print(f"dpt {kind} kernel vs twin [8,{n},{DPT_S},{DPT_B}] "
                      f"K={K} {name} x std {x_scale}: rel_l2 {err:.3e} (bar "
                      f"{DPT_TOL[name]:.0e}) max_abs {abs_err:.3e}{at}",
                      flush=True)
                if (not finite or not err <= DPT_TOL[name]
                        or not order <= TP_ORDER_TOL[name]):
                    failures.append(f"{kind} n={n} {name} x std {x_scale}: "
                                    f"rel_l2 {err:.3e}{at}"
                                    f"{'' if finite else ', non-finite'}")
    check(not failures, "DPT kernels disagree with their twins: "
          + "; ".join(failures))
    return worst


DPT_GRAD_NAMES = {
    "inter": ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out"),
    "intra": ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out"),
    "ffn": ("dx", "dgamma", "dbeta", "dw_up", "db_up", "dw_down", "db_down")}
# the backward kernels in f32 against the exact twin differ in summation
# order only (<= 1.5e-6 at n = 1..94): 1e-5, under the JAX package's VJP
# gate of 1e-4, which an erf-GELU derivative (~1e-4) could pass
DPT_BWD_TOL_F32 = 1e-5


def dpt_bwd_fns(dpt, kind: str):
    """(backward kernel wrapper, plain twin) of one DPT sublayer."""
    return {"inter": (dpt["inter"].fused_inter_attention_bwd,
                      dpt["inter"].inter_attention_bwd_reference),
            "intra": (dpt["intra"].fused_intra_attention_bwd,
                      dpt["intra"].intra_attention_bwd_reference),
            "ffn": (dpt["ffn"].fused_ffn_bwd,
                    dpt["ffn"].ffn_bwd_reference)}[kind]


def dpt_bwd_inputs(torch, kind: str, dtype, n: int, K: int, seed: int,
                   S=DPT_S, heads=DPT_HEADS, B=DPT_B, F=DPT_F):
    """(x, g, the f32 weights, kwargs, valid [n, S]): ``dpt_inputs`` with
    the weights in f32, as the model keeps them, and a random cotangent
    that is zero on the padded rows, as the model delivers it."""
    args, kw, valid = dpt_inputs(torch, kind, dtype, n, K, seed, S=S,
                                 heads=heads, B=B, F=F)
    x = args[0]
    g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1))
    g = (g.reshape(8, -1, B) * valid.reshape(1, -1, 1)).reshape(x.shape)
    weights = [None if a is None else a.float() for a in args[1:]]
    return x, g.to(dtype), weights, kw, valid


def phase_dpt_bwd_vs_twin(torch, dpt):
    """Each DPT backward kernel (B8, B10, B12) against its plain twin at the
    quality default's widths with the real key mask, n = 1, 25 and 94,
    bf16 and f32, a random cotangent zero on the padded rows: every
    cotangent (dx on the valid rows) against the exact f32 cotangents of
    the twin, by relative L2; in f32 within DPT_BWD_TOL_F32; in bf16 within
    4e-2 of the bf16 twin and no further from exact than max(4e-2, 1.25x
    the bf16 twin's own distance). The intra backward also at chunks of
    S = 256 (n = 13, 4 s): in bf16 the core of B8 and B10
    (``csrc/dpt_attn_bwd_wg.cuh``) keeps no [S, S] tile at any length, in
    f32 the first design's [S, S] tiles leave shared memory for the device
    workspace there; n = 94 runs the bf16 inter core over six 16-row
    tiles. Every case is printed before the phase fails;
    returns the worst max_abs_err per kernel (against the twin in the same
    dtype)."""
    worst = {k: 0.0 for k in DPT_KINDS}
    failures = []
    for kind in DPT_KINDS:
        fused, twin = dpt_bwd_fns(dpt, kind)
        names = DPT_GRAD_NAMES[kind]
        shapes = [(n, K, DPT_S) for n, K in DPT_SHAPES]
        if kind == "intra":
            shapes.append((13, 3199, 256))
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            for n, K, S in shapes:
                x, g, w, kw, valid = dpt_bwd_inputs(torch, kind, dtype, n, K,
                                                    seed=5000 + n, S=S)
                got = fused(x, g, *w, **kw)
                torch.cuda.synchronize()
                exact = twin(x.float(), g.float(), *w, **kw)
                same = twin(x, g, *w, **kw) if dtype == torch.bfloat16 \
                    else exact
                torch.cuda.synchronize()
                head = (f"dpt {kind} bwd kernel vs twin [8,{n},{S},"
                        f"{DPT_B}] K={K} {name}")
                worst[kind] = max(worst[kind], compare_cotangents(
                    torch, head, names, got, exact, same, valid, dtype,
                    failures))
    check(not failures, "DPT backward kernels disagree with their twins: "
          + "; ".join(failures))
    return worst


def compare_cotangents(torch, head: str, names, got, exact, same, valid,
                       dtype, failures: list) -> float:
    """A DPT backward kernel's cotangents ``got`` against its twin's exact
    f32 ones and its twin's in the same dtype (``same``), dx on the valid
    rows: in f32 within DPT_BWD_TOL_F32 of exact; in bf16 within 4e-2 of
    the bf16 twin and no further from exact than max(4e-2, 1.25x the bf16
    twin's own distance). Prints one line headed ``head``, appends what
    fails to ``failures`` and returns the largest absolute difference from
    the twin in the same dtype."""
    name = str(dtype).split(".")[-1]
    rows = valid.reshape(-1)

    def pick(t, i):
        return t.reshape(t.shape[0], -1, t.shape[-1])[:, rows] if i == 0 \
            else t

    errs, twin_errs, same_errs = {}, {}, {}
    worst = 0.0
    for i, gname in enumerate(names):
        q, e, t = (pick(v[i], i) for v in (got, exact, same))
        if not (q.shape == t.shape and q.dtype == t.dtype):
            failures.append(f"{head} {gname}: {q.shape} {q.dtype} vs "
                            f"{t.shape} {t.dtype}")
            continue
        if not torch.isfinite(q).all().item():
            failures.append(f"{head}: non-finite {gname}")
        errs[gname] = rel_l2(q, e)
        twin_errs[gname] = rel_l2(t, e)
        same_errs[gname] = rel_l2(q, t)
        worst = max(worst, (q.float() - t.float()).abs().max().item())
    top = max(errs, key=errs.get)
    line = (f"{head}: vs exact max {errs[top]:.3e} ({top}), dx "
            f"{errs['dx']:.3e}")
    if dtype == torch.float32:
        print(f"{line} (bar {DPT_BWD_TOL_F32:.0e})", flush=True)
        if errs[top] > DPT_BWD_TOL_F32:
            failures.append(f"{head}: {errs[top]:.3e} ({top})")
        return worst
    bad = [gname for gname in errs
           if same_errs[gname] > DPT_TOL[name]
           or errs[gname] > max(DPT_TOL[name], 1.25 * twin_errs[gname])]
    top_s = max(same_errs, key=same_errs.get)
    top_t = max(twin_errs, key=twin_errs.get)
    print(f"{line}; vs the bf16 twin max {same_errs[top_s]:.3e} ({top_s}); "
          f"bf16 twin vs exact max {twin_errs[top_t]:.3e} ({top_t})",
          flush=True)
    if bad:
        failures.append(f"{head}: " + ", ".join(
            f"{b} {errs[b]:.3e} (twin {twin_errs[b]:.3e}, vs twin "
            f"{same_errs[b]:.3e})" for b in bad))
    return worst


def dpt_config(dtype: str = "bfloat16"):
    """The repo's DPT quality default (bench.py's dpt line): N=256, L=20,
    B=256, chunk 128, 4 layers, 8 heads of 32, F=1024, C=2, relu."""
    from convtasnet_tpu_torch import ConvTasNetConfig

    return ConvTasNetConfig(separator="dpt", compute_dtype=dtype)


def dpt_launches(dpt):
    return {kind: dpt_fns(dpt, kind)[0].launches for kind in DPT_KINDS}


def phase_dpt_forward(torch, dpt):
    """The DPT forward at the quality default, bf16, B=8 x 4 s, random
    weights from seed 0: kernel path against plain path within 4e-2, and
    each kernel launched per forward as the model's layers call it (4
    inter, 4 intra, 8 FFN)."""
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    cfg = dpt_config()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    outs = {}
    for path, flag in (("kernel", None), ("plain", False)):
        model = ConvTasNet(cfg, use_pallas=flag, device="cuda",
                           generator=torch.Generator().manual_seed(0)).eval()
        reset_dpt_all(dpt)
        with torch.inference_mode():
            outs[path] = model(mix)
        torch.cuda.synchronize()
        counts = dpt_launches(dpt)
        want = ({"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                 "ffn": 2 * cfg.dpt_layers} if flag is None
                else dict.fromkeys(DPT_KINDS, 0))
        print(f"dpt forward {path} path B=8x{SECONDS}s bf16: launches "
              f"{counts} (expected {want})", flush=True)
        check(counts == want, f"dpt forward {path} path launched {counts}, "
              f"expected {want}")
    err = rel_l2(outs["kernel"], outs["plain"])
    print(f"dpt forward B=8x{SECONDS}s bf16: kernel path vs plain path "
          f"rel_l2 {err:.3e} (bar {TOL['bfloat16']:.0e})", flush=True)
    check(torch.isfinite(outs["kernel"]).all().item()
          and tuple(outs["kernel"].shape) == (8, 2, SECONDS * SAMPLE_RATE),
          "dpt forward: non-finite or misshapen output")
    check(err <= TOL["bfloat16"], f"dpt forward paths disagree: {err:.3e}")


def dpt_bwd_launches(dpt):
    return {kind: dpt_bwd_fns(dpt, kind)[0].launches for kind in DPT_KINDS}


def phase_dpt_train_path(torch, dpt, work: str, data: str, json_dir: str):
    """``cli train --separator dpt`` in process at the DPT quality default,
    bf16, ``--use-pallas 1``, on the corpus of ``make_corpus``: one epoch
    of 4 steps at batch 8 x 4 s and a cv pass. Every loss finite;
    per step 4 / 4 / 8 launches of the inter, intra and FFN forward
    kernels and of their backward kernels; the cv batches run the forwards
    only; then ``separate`` with the best-model package on the card.
    Returns the backward kernels' launches."""
    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.infer.separate import separate

    cfg = dpt_config()
    per_step = {"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                "ffn": 2 * cfg.dpt_layers}
    n_cv = 2
    out = os.path.join(work, "exp_dpt")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    reset_dpt_all(dpt)
    t0 = time.perf_counter()
    rc = cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cuda", "--separator", "dpt", "--compute-dtype",
        "bfloat16", "--use-pallas", "1", "--epochs", "1", "--batch-size", "8",
        "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = dpt_launches(dpt), dpt_bwd_launches(dpt)
    check(rc == 0, f"cli train --separator dpt returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train --separator dpt (quality default, bf16, --use-pallas "
          f"1): {n_steps} steps, losses {[round(x, 4) for x in losses]}, cv "
          f"loss {[r['loss'] for r in records if r.get('split') == 'valid']},"
          f" forward launches {fwd}, backward launches {bwd}, {wall:.1f} s "
          f"wall", flush=True)
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    want_bwd = {k: v * n_steps for k, v in per_step.items()}
    want_fwd = {k: v * (n_steps + n_cv) for k, v in per_step.items()}
    check(bwd == want_bwd, f"backward kernels launched {bwd}, expected "
          f"{want_bwd} ({per_step} per step)")
    check(fwd == want_fwd, f"forward kernels launched {fwd}, expected "
          f"{want_fwd} ({per_step} per step and per cv batch)")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    sep_dir = os.path.join(work, "sep_trained_dpt")
    mix_dir = os.path.join(data, "cv", "mix")
    reset_dpt_all(dpt)
    n = separate(pkg, sep_dir, mix_dir=mix_dir, batch_size=n_cv,
                 device="cuda")
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    sep = dpt_launches(dpt)
    check(n == n_cv and sep == per_step,
          f"separate with the trained DPT package: {n} utterances, "
          f"launches {sep}")
    check_wavs(sep_dir, mix_dir)
    print(f"separate with the trained DPT package: {n} utterances, "
          f"launches {sep} (1 batch)", flush=True)
    return bwd


def phase_ffn_bwd_tail_tiles(torch, dpt):
    """B12 and B12p (one shard of m = 2 and 4) at rows that fill no whole
    number of 128-row tiles: x [8, 3199, 256] (R = 25,592, the last tile
    120 rows), F = 1024 (/ m), the biases off 0, a random cotangent, bf16
    and f32; every cotangent against the twin's exact f32 ones as
    ``phase_dpt_bwd_vs_twin`` holds them, db_down zero in partial mode.
    Every case is printed before the phase fails."""
    fused, twin = dpt_bwd_fns(dpt, "ffn")
    failures = []
    valid = torch.ones(3199, dtype=torch.bool, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        args, _, _ = dpt_inputs(torch, "ffn", dtype, 1, 3199, seed=7100,
                                S=3199)
        x = args[0]
        w = [a.float() for a in args[1:]]
        g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(7101)).to(dtype)
        for m in (1,) + DPT_TP_SHARDS:
            kw = {} if m == 1 else dict(partial=True)
            ws = w if m == 1 else list(dpt_shard(
                torch, (x, *w), "ffn", m, m - 1)[1:])
            got = fused(x, g, *ws, **kw)
            torch.cuda.synchronize()
            exact = twin(x.float(), g.float(), *ws, **kw)
            same = twin(x, g, *ws, **kw) if dtype == torch.bfloat16 \
                else exact
            names = DPT_GRAD_NAMES["ffn"]
            head = (f"dpt ffn bwd kernel vs twin [8,3199,{DPT_B}] "
                    f"F={DPT_F // m}{'' if m == 1 else f' partial m={m}'} "
                    f"{name}")
            if m > 1:
                if got[-1].any().item():
                    failures.append(f"{head}: db_down not zero")
                got, exact, same, names = (got[:-1], exact[:-1], same[:-1],
                                           names[:-1])
            compare_cotangents(torch, head, names, got, exact, same, valid,
                               dtype, failures)
    check(not failures, "B12 at a tail tile disagrees with its twin: "
          + "; ".join(failures))


def phase_auto_padded(torch, k, dpt):
    """Under ``use_pallas=None`` (the CLI's ``--use-pallas -1``), widths off
    the kernels' tiles run padded through the kernels: the paper config at
    B = H = 96 (B1 and B2 pad both to 128, their norms over the block's
    own 96 channels) and the DPT quality default with 100-frame chunks and
    F = 1000 (B9 and B10 pad S to 112 with masked frames, B11 and B12 F to
    1024), bf16, random weights from seed 0. One model of each serves a
    B=8 x 4 s batch and trains a step on another: every block or sublayer
    launches its kernel (TCN: 32 B1 in each forward, 32 B2; DPT: 4 B7, 4
    B9 and 8 B11 in each forward, 4 B8, 4 B10 and 8 B12), the served
    output finite and within the bf16 forward bar of the plain model, the
    step's loss finite; so does the DPT quality default at ``--B 96`` (3
    heads of 32: B7-B12 pad B to 128 with zero columns and the heads with a
    zero head, each LN over the real 96 columns), and at ``--B 96
    --dpt-heads 2`` (2 heads of 48, each widened with zero columns to 64
    and run with the scale of 48), with the same counts. A shape no kernel
    takes, which the JAX package refuses too (the paper config with P = 4
    outside the causal mode), raises under auto as with
    ``use_pallas=True``, before any launch."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import shapes
    from convtasnet_tpu_torch.train import train_step as ts

    t0 = time.perf_counter()
    mix = train_batch(torch, 8, 61)[0]
    batch = train_batch(torch, 8, 62)
    none = dict.fromkeys(DPT_KINDS, 0)
    cases = (
        # forward: the served batch and the step's forward; backward: the
        # step's
        ("tcn B=H=96", ConvTasNetConfig(compute_dtype="bfloat16",
                                        bottleneck=96, hidden=96),
         tcn_want(b1=2 * 32, b2=32), none, none),
        ("dpt chunk 100, F=1000", ConvTasNetConfig(
            separator="dpt", compute_dtype="bfloat16", dpt_chunk=100,
            dpt_ff=1000), tcn_want(),
         {"inter": 2 * 4, "intra": 2 * 4, "ffn": 2 * 8},
         {"inter": 4, "intra": 4, "ffn": 8}),
        ("dpt --B 96", ConvTasNetConfig(
            separator="dpt", compute_dtype="bfloat16", bottleneck=96),
         tcn_want(), {"inter": 2 * 4, "intra": 2 * 4, "ffn": 2 * 8},
         {"inter": 4, "intra": 4, "ffn": 8}),
        ("dpt --B 96 --dpt-heads 2", ConvTasNetConfig(
            separator="dpt", compute_dtype="bfloat16", bottleneck=96,
            dpt_heads=2), tcn_want(),
         {"inter": 2 * 4, "intra": 2 * 4, "ffn": 2 * 8},
         {"inter": 4, "intra": 4, "ffn": 8}))
    for label, cfg, want_tcn, want_fwd, want_bwd in cases:
        check(not shapes.refusals(cfg), f"auto mode {label}: refused "
              f"{shapes.refusals(cfg)}")
        plain = ConvTasNet(cfg, use_pallas=False, device="cuda").eval()
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda")
        state.model.load_state_dict(plain.state_dict())
        tcn_reset(k)
        reset_dpt_all(dpt)
        with pair_switch(False):
            state.model.eval()
            with torch.inference_mode():
                got, want = state.model(mix), plain(mix)
            state, metrics = ts.make_train_step()(state, batch)
            torch.cuda.synchronize()
        tcn = tcn_counts(k)
        fwd = {kind: dpt_fns(dpt, kind)[0].launches for kind in DPT_KINDS}
        bwd = {kind: dpt_bwd_fns(dpt, kind)[0].launches for kind in DPT_KINDS}
        err = rel_l2(got, want)
        loss = float(metrics["loss"])
        print(f"auto mode, {label}: TCN launches {tcn}, DPT forward {fwd} "
              f"backward {bwd}; served vs plain rel_l2 {err:.3e} (bar "
              f"{TOL['bfloat16']:.0e}); step loss {loss:.4f}", flush=True)
        check(tcn == want_tcn, f"auto mode {label}: TCN launches {tcn}")
        check(fwd == want_fwd and bwd == want_bwd, f"auto mode {label}: DPT "
              f"launches {fwd} / {bwd}, expected {want_fwd} / {want_bwd}")
        check(torch.isfinite(got).all().item() and err <= TOL["bfloat16"]
              and math.isfinite(loss), f"auto mode {label}: {err:.3e}, "
              f"loss {loss}")
        del plain, state
    refused = ConvTasNetConfig(compute_dtype="bfloat16", conv_kernel=4)
    tcn_reset(k)
    reset_dpt_all(dpt)
    for use_pallas in (None, True):
        model = ConvTasNet(refused, use_pallas=use_pallas,
                           device="cuda").eval()
        try:
            with torch.inference_mode():
                model(mix)
            raised = "nothing"
        except ValueError as e:
            raised = str(e)
        print(f"auto mode, tcn P=4 non-causal: use_pallas={use_pallas} "
              f"raises {raised!r}", flush=True)
        check("odd kernel size" in raised,
              f"tcn P=4 use_pallas={use_pallas} raised {raised!r}")
        del model
    launched = {**tcn_counts(k), **{kind: dpt_fns(dpt, kind)[0].launches
                                    for kind in DPT_KINDS}}
    check(not any(launched.values()), f"tcn P=4 launched {launched}")
    print(f"auto mode phase: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_intra_f32_wide_heads(torch, dpt):
    """The intra forward (B9) and backward (B10) in f32 with a head width
    of 64 (4 heads of B = 256) at S = 256 (n = 13, 4 s), where their
    [S, d] tiles do not fit in shared memory and go to the device
    workspace: on the valid rows against the exact twin within the f32
    DPT bars (1e-5 both), the backward on every cotangent."""
    fused, twin = dpt_fns(dpt, "intra")
    fused_b, twin_b = dpt_bwd_fns(dpt, "intra")
    args, kw, valid = dpt_inputs(torch, "intra", torch.float32, 13, 3199,
                                 seed=7100, S=256, heads=4)
    rows = valid.reshape(-1)
    with torch.inference_mode():
        got = fused(*args, **kw)
        torch.cuda.synchronize()
        want = twin(*args, **kw)
    fwd = rel_l2(got.reshape(8, -1, DPT_B)[:, rows],
                 want.reshape(8, -1, DPT_B)[:, rows])
    x, g, w, kw, valid = dpt_bwd_inputs(torch, "intra", torch.float32, 13,
                                        3199, seed=7200, S=256, heads=4)
    got_b = fused_b(x, g, *w, **kw)
    torch.cuda.synchronize()
    exact = twin_b(x, g, *w, **kw)
    errs = {}
    for i, name in enumerate(DPT_GRAD_NAMES["intra"]):
        q, e = got_b[i], exact[i]
        if i == 0:
            q, e = (v.reshape(8, -1, DPT_B)[:, rows] for v in (q, e))
        errs[name] = rel_l2(q, e) if torch.isfinite(q).all().item() \
            else math.inf
    top = max(errs, key=errs.get)
    print(f"dpt intra f32 head width 64 [8,13,256,{DPT_B}] K=3199: forward "
          f"kernel vs twin rel_l2 {fwd:.3e} (bar {DPT_TOL['float32']:.0e}); "
          f"backward vs exact max {errs[top]:.3e} ({top}; bar "
          f"{DPT_BWD_TOL_F32:.0e})", flush=True)
    check(fwd <= DPT_TOL["float32"] and errs[top] <= DPT_BWD_TOL_F32,
          f"intra kernels at S = 256, head width 64, f32: forward "
          f"{fwd:.3e}, backward {errs[top]:.3e} ({top})")


def tp_stage2_inputs(torch, dtype, Hs: int, seed: int, M=8, K=3199, B=256,
                     H=512, P=3):
    """Seeded stage-2 operands of one shard of the paper config's H at the
    serving shape: h as stage 1 leaves it (PReLU of unit-scale values, in
    the compute dtype), gLN-1 statistics near h's own, paper-init weight
    scales of the whole width, random norm affines; f32 weights, as the
    model keeps them."""
    g = torch.Generator(device="cuda").manual_seed(2000 + seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    h = torch.nn.functional.leaky_relu(rn(M, K, Hs), 0.25).to(dtype)
    hf = h.float()
    mean = hf.mean(dim=(1, 2))
    rs = torch.rsqrt(hf.square().mean(dim=(1, 2)) - mean.square() + 1e-8)
    stats1 = torch.stack([mean * (1 + 0.1 * rn(M)), rs * (1 + 0.1 * rn(M))],
                         dim=-1)
    return (h, stats1, rn(P, Hs) * (2.0 / (P + H * P)) ** 0.5,
            rn(Hs, B) * (2.0 / (B + H)) ** 0.5,
            torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(Hs),
            0.1 * rn(Hs), 1.0 + 0.1 * rn(Hs))


# B6's cases beyond two and four shards of H = 512: the other shard
# widths its bf16 wgmma stage takes, (Hs, dilations), bf16 and f32 (f32's
# depthwise stage on dw_rows_f32)
TP_WG_WIDTHS = ((512, (1, 16, 128)), (64, (1, 16, 128)))
# a width off dw_layout_ok (f32's depthwise stage one channel a thread),
# f32 only
TP_F32_WIDTHS = ((448, (1, 16, 128)),)
# shard widths past 512 (bf16 B6's wide route, y through device memory):
# one tile past it (H = 1152 over two) and two shards of H = 2048, (Hs,
# dilations), bf16 and f32
TP_WIDE_WIDTHS = ((576, (1, 16, 128)), (1024, (1, 16, 128)))
TP_WIDE_TIMED = (576, 768, 1024)   # the widths past 512 timed


def phase_tp_stage2_vs_twin(torch, k):
    """Kernel B6 (TP stage 2) against its twin at [8, 3199, Hs] (the last
    128-row tile holds 127 rows), Hs = 256 and 128 (two and four shards of
    H = 512), every dilation 1..128, gLN non-causal and causal, bf16 and
    f32; at the bf16 wgmma stage's other widths, Hs = 512 and 64, in both
    dtypes, f32 at 448, and past 512 at Hs = 576 and 1024 (shards of H =
    1152 and 2048; bf16 on its wide route) in bf16 and f32, d = 1, 16,
    128: z and the gLN-2 sums within the
    forward bars (4e-2 / 2e-3), against the twin at B6's own rounding
    points within TP_ORDER_TOL, finite, and two calls the same bits. Every
    case is printed before the phase fails; returns the worst max_abs_err
    of z."""
    tp = k["tp"]
    worst = 0.0
    failures = []
    t0 = time.perf_counter()
    cases = [(Hs, dtype, DILATIONS) for Hs in (256, 128)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(Hs, dtype, ds) for Hs, ds in TP_WG_WIDTHS
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(Hs, torch.float32, ds) for Hs, ds in TP_F32_WIDTHS]
    cases += [(Hs, dtype, ds) for Hs, ds in TP_WIDE_WIDTHS
              for dtype in (torch.bfloat16, torch.float32)]
    n_cases = 0
    for Hs, dtype, dilations in cases:
            name = str(dtype).split(".")[-1]
            for causal in (False, True):
                for d in dilations:
                    n_cases += 1
                    args = tp_stage2_inputs(torch, dtype, Hs, d,
                                            H=2 * Hs if Hs > 512 else 512)
                    kw = dict(dilation=d, causal=causal)
                    with torch.inference_mode():
                        z, sums = tp.fused_tp_stage2(*args, **kw)
                        z2, sums2 = tp.fused_tp_stage2(*args, **kw)
                        torch.cuda.synchronize()
                        zw, sw = tp.tp_stage2_reference(*args, **kw)
                        zo, so = tp.tp_stage2_reference(*args, **kw,
                                                        rounding="pallas")
                    same = torch.equal(z, z2) and torch.equal(sums, sums2)
                    finite = (torch.isfinite(z).all().item()
                              and torch.isfinite(sums).all().item())
                    ez, es = rel_l2(z, zw), rel_l2(sums, sw)
                    eo = max(rel_l2(z, zo), rel_l2(sums, so))
                    abs_err = (z.float() - zw.float()).abs().max().item()
                    worst = max(worst, abs_err)
                    print(f"tp stage 2 (B6) vs twin [8,3199,{Hs}] B=256 gLN "
                          f"causal={int(causal)} {name} d={d}: z rel_l2 "
                          f"{ez:.3e}, sums rel_l2 {es:.3e} (bar "
                          f"{TOL[name]:.0e}) max_abs {abs_err:.3e}; vs the "
                          f"twin at B6's rounding points {eo:.3e} (bar "
                          f"{TP_ORDER_TOL[name]:.0e}); same bits twice "
                          f"{same}", flush=True)
                    if not (finite and same and ez <= TOL[name]
                            and es <= TOL[name] and eo <= TP_ORDER_TOL[name]):
                        failures.append(
                            f"Hs={Hs} {name} causal={int(causal)} d={d}: z "
                            f"{ez:.3e} sums {es:.3e} rounding points {eo:.3e}"
                            f" finite {finite} same {same}")
    print(f"tp stage 2 (B6) vs twin: {n_cases} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(not failures, "TP stage-2 kernel disagrees with its twin: "
          + "; ".join(failures))
    return worst


def phase_tp_forward(torch, k, hidden: int = 512, shards=TP_SHARDS):
    """``tp_forward`` of the paper config (random weights from seed 0; its
    hidden width ``hidden``) at B=8 x 4 s over each of ``shards``, all on
    cuda:0, bf16 and f32: 32 m launches of B6 and none of any other TCN
    kernel, finite, and within the forward bars of the unsharded kernel
    path (blocks singly) and of the plain path."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    t0 = time.perf_counter()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    for dtype in ("bfloat16", "float32"):
        cfg = ConvTasNetConfig(compute_dtype=dtype, hidden=hidden)
        n_blocks = cfg.num_repeats * cfg.num_blocks
        kernel = ConvTasNet(cfg, use_pallas=True, device="cuda").eval()
        plain = ConvTasNet(cfg, use_pallas=False, device="cuda").eval()
        with torch.inference_mode(), pair_switch(False):
            want_k, want_p = kernel(mix), plain(mix)
            sd = kernel.state_dict()
            for m in shards:
                devices = shard_devices(m, "cuda")
                tcn_reset(k)
                got = tp_forward(cfg, sd, mix, devices)
                torch.cuda.synchronize()
                counts = tcn_counts(k)
                ek, ep = rel_l2(got, want_k), rel_l2(got, want_p)
                print(f"tp_forward paper config H={hidden} "
                      f"B=8x{SECONDS}s {dtype} over "
                      f"{m} shards on {sorted({str(d) for d in devices})}: "
                      f"vs the unsharded kernel path rel_l2 {ek:.3e}, vs the "
                      f"plain path {ep:.3e} (bar {TOL[dtype]:.0e}); launches "
                      f"{counts}", flush=True)
                want = tcn_want(b6=n_blocks * m)
                check(counts == want, f"tp_forward {dtype} m={m} launched "
                      f"{counts}, expected {want}")
                check(torch.isfinite(got).all().item()
                      and got.shape == want_k.shape,
                      f"tp_forward {dtype} m={m}: bad output")
                check(ek <= TOL[dtype] and ep <= TOL[dtype],
                      f"tp_forward {dtype} m={m}: {ek:.3e} / {ep:.3e}")
        del kernel, plain
    print(f"tp_forward phase: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_tp_train_path(torch, k, work: str, data: str, json_dir: str,
                        hidden: int = 512):
    """``cli train --n-model 2 --use-pallas 1`` at the paper config (its
    hidden width ``hidden``), bf16, on the corpus of ``make_corpus`` (one
    epoch of 4 steps at batch 8 and a cv pass): every loss finite, B6
    launched 64 times per step and per cv batch and no other TCN kernel;
    then its package served through ``cli separate --tensor-parallel 2``
    (64 B6 per batch) against the unsharded ``cli separate`` (32 kernel-1
    launches, pairs off): finite wavs within the bf16 forward bar. Returns
    the launch counts of the train run."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav

    n_blocks, n_cv, m = 32, 2, 2
    out = os.path.join(work, f"exp_tp_H{hidden}")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    buf = io.StringIO()
    tcn_reset(k)
    t0 = time.perf_counter()
    with pair_switch(False), contextlib.redirect_stdout(buf):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--compute-dtype", "bfloat16",
            "--use-pallas", "1", "--n-model", str(m), "--epochs", "1",
            "--batch-size", "8", "--print-freq", "1", "--H", str(hidden)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tcn_counts(k)
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    check(rc == 0, f"cli train --n-model {m} returned {rc}")
    placement = buf.getvalue().splitlines()[0]
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train --n-model {m} (paper config, --H {hidden}, bf16, "
          f"--use-pallas 1; {placement}): {n_steps} steps, losses "
          f"{[round(x, 4) for x in losses]}, cv loss "
          f"{[r['loss'] for r in records if r.get('split') == 'valid']}, "
          f"launches {counts}, {wall:.1f} s wall", flush=True)
    check(placement.startswith(f"tensor parallel over {m} shards"),
          f"no placement line: {placement!r}")
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    want = tcn_want(b6=n_blocks * m * (n_steps + n_cv))
    check(counts == want, f"cli train --n-model {m} launched {counts}, "
          f"expected {want} ({n_steps} steps + {n_cv} cv batches)")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    mix_dir = os.path.join(data, "cv", "mix")
    outs = {}
    for label, flags, want_sep in (
            ("tensor-parallel", ["--tensor-parallel", str(m)],
             tcn_want(b6=n_blocks * m)),
            ("unsharded", [], tcn_want(b1=n_blocks))):
        sep_dir = os.path.join(work, f"sep_tp_H{hidden}_{label}")
        tcn_reset(k)
        with pair_switch(False), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["separate", "--model-path", pkg, "--mix-dir",
                           mix_dir, "--out-dir", sep_dir, "--batch-size",
                           str(n_cv), "--device", "cuda", *flags])
        torch.cuda.synchronize()
        sep = tcn_counts(k)
        check(rc == 0 and sep == want_sep, f"cli separate ({label}): rc {rc}"
              f", launches {sep}, expected {want_sep}")
        check_wavs(sep_dir, mix_dir)
        outs[label] = np.concatenate([
            read_wav(os.path.join(sep_dir, f))[0]
            for f in sorted(os.listdir(sep_dir)) if "_s" in f])
    err = rel_l2(torch.from_numpy(outs["tensor-parallel"]),
                 torch.from_numpy(outs["unsharded"]))
    print(f"cli separate --tensor-parallel {m} with the trained package "
          f"(H={hidden}): launches {tcn_want(b6=n_blocks * m)} (1 batch), "
          f"wavs vs the "
          f"unsharded cli separate rel_l2 {err:.3e} (bar "
          f"{TOL['bfloat16']:.0e}); train and separate phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(err <= TOL["bfloat16"], f"tensor-parallel separate disagrees: "
          f"{err:.3e}")
    return counts


def phase_tp_wide(torch, k, work: str, data: str, json_dir: str):
    """Shards wider than 512 channels, B6 on its wide route: the paper
    config at H = 2048 over two shards (Hs = 1024) served by
    ``tp_forward`` in bf16 and f32 (64 B6 launches, no other TCN kernel,
    within the forward bars of the unsharded kernel path, B1 at H = 2048,
    and of plain); then ``cli train --H 2048 --n-model 2 --use-pallas 1``
    (4 steps and a cv pass, losses finite) and its package through ``cli
    separate --tensor-parallel 2`` against the unsharded ``cli
    separate``, launches exact throughout."""
    t0 = time.perf_counter()
    phase_tp_forward(torch, k, hidden=2048, shards=(2,))
    phase_tp_train_path(torch, k, work, data, json_dir, hidden=2048)
    print(f"tp wide phase (H=2048 over 2 shards): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def dpt_step_medians(torch, dpt, cfg, sd, seeds, label: str, kinds,
                     first_batch=None):
    """One bf16 train step (loss and gradients) of the DPT ``cfg`` from
    the state dict ``sd`` per batch seed (B=4 x 4 s; ``first_batch`` for
    the first seed), kernel path against plain path: every loss within
    4e-2 and the kernel path's gradient finite; each path's distance from
    the plain f32 gradient, the kernel path's within ``SEED_CEILING`` times
    the plain bf16 path's at every seed and, by the medians over the
    seeds, within max(8e-2, 1.25x): at random init each seed's distance is
    one draw of 1 / c of the least correlated (estimate, source) pair
    (PERF.md §6). The backward kernels
    of ``kinds`` launch once per layer (the FFN's twice) on the kernel
    path, none on the plain paths."""
    import dataclasses

    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    dists = []
    for i, seed in enumerate(seeds):
        step_batch = (first_batch if i == 0 and first_batch is not None
                      else train_batch(torch, 4, seed))
        res = {}
        for path, flag, dtype in (("kernel", True, "bfloat16"),
                                  ("plain", False, "bfloat16"),
                                  ("plain f32", False, "float32")):
            state = ts.create_train_state(
                dataclasses.replace(cfg, compute_dtype=dtype),
                SolverConfig(), device="cuda", use_pallas=flag,
                state_dict=sd)
            reset_dpt_all(dpt)
            loss = float(ts._loss_and_grads(state.model, step_batch, 0))
            torch.cuda.synchronize()
            counts = {k: dpt_bwd_fns(dpt, k)[0].launches for k in kinds}
            check(counts == {k: (2 if k == "ffn" else 1) * cfg.dpt_layers
                             if flag else 0 for k in kinds},
                  f"dpt {label} {path}: backward launches {counts}")
            res[path] = (loss, torch.cat([
                p.grad.detach().float().reshape(-1)
                for p in state.model.parameters()]))
            del state
        (lk, gk), (lp, gp), (_, gf) = (res["kernel"], res["plain"],
                                       res["plain f32"])
        loss_rel = abs(lk - lp) / abs(lp)
        k_f32, p_f32 = rel_l2(gk, gf), rel_l2(gp, gf)
        dists.append((k_f32, p_f32))
        print(f"train step dpt {label} bf16 B=4x{SECONDS}s seed {seed} "
              f"kernel vs plain: loss {lk:.6f} vs {lp:.6f} (rel "
              f"{loss_rel:.3e}); from the f32 gradient: kernel path "
              f"{k_f32:.3e}, plain path {p_f32:.3e}", flush=True)
        check(torch.isfinite(gk).all().item() and loss_rel <= 4e-2,
              f"dpt {label} seed {seed} step: loss {loss_rel:.3e}")
    k_f32 = statistics.median(k for k, _ in dists)
    p_f32 = statistics.median(p for _, p in dists)
    bar = max(BWD_TOL["bfloat16"], 1.25 * p_f32)
    worst = max(k / p for k, p in dists)
    print(f"train step dpt {label}: kernel path {k_f32:.3e} from the f32 "
          f"gradient (median of {len(dists)}), bar {bar:.3e}; largest "
          f"ratio to the plain path {worst:.3f} (ceiling {SEED_CEILING})",
          flush=True)
    check(k_f32 <= bar and worst <= SEED_CEILING,
          f"dpt {label} step: gradient {k_f32:.3e}, ratio {worst:.3f}")


def dpt_forward_vs_plain(torch, dpt, cfg, sd, mix, label: str):
    """One forward of the DPT ``cfg`` from the state dict ``sd`` on ``mix``
    [M, T], kernel path against plain path: B7 and B9 once per layer and
    B11 twice on the kernel path, no launch on the plain path, and the
    kernel path's output finite, of the mixture's shape and within the
    forward bar of ``cfg``'s compute dtype (``TOL``)."""
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    dtype = cfg.compute_dtype
    outs = {}
    for path, flag in (("kernel", True), ("plain", False)):
        model = ConvTasNet(cfg, use_pallas=flag, device="cuda").eval()
        model.load_state_dict(sd)
        reset_dpt_all(dpt)
        with torch.inference_mode():
            outs[path] = model(mix)
        torch.cuda.synchronize()
        counts = dpt_launches(dpt)
        want = ({"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                 "ffn": 2 * cfg.dpt_layers} if flag
                else dict.fromkeys(DPT_KINDS, 0))
        print(f"dpt forward {label} {path} path {dtype}: launches {counts} "
              f"(expected {want})", flush=True)
        check(counts == want, f"dpt {label} {dtype} forward {path}: "
              f"{counts}")
        del model
    err = rel_l2(outs["kernel"], outs["plain"])
    print(f"forward dpt {label} {dtype} B={mix.shape[0]}x{SECONDS}s kernel "
          f"vs plain: rel_l2 {err:.3e} (bar {TOL[dtype]:.0e})", flush=True)
    check(torch.isfinite(outs["kernel"]).all().item()
          and tuple(outs["kernel"].shape) == (mix.shape[0], 2, mix.shape[1])
          and err <= TOL[dtype], f"dpt {label} {dtype} forward: {err:.3e}")


def dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label: str):
    """One f32 train step (loss and gradients) of the DPT ``cfg`` from the
    state dict ``sd`` on ``batch``, kernel path against plain path: the
    kernel path's gradient finite and within the f32 step bar
    (``BWD_TOL``, 4e-3, as ``tests/test_torch_cuda.py``'s
    ``test_dpt_model_train_grads_kernel_vs_plain`` holds it), B8 and B10
    once per layer and B12 twice on the kernel path, none on the plain
    path."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    res = {}
    for path, flag in (("kernel", True), ("plain", False)):
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=flag, state_dict=sd)
        reset_dpt_all(dpt)
        loss = float(ts._loss_and_grads(state.model, batch, 0))
        torch.cuda.synchronize()
        counts = dpt_bwd_launches(dpt)
        want = ({"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                 "ffn": 2 * cfg.dpt_layers} if flag
                else dict.fromkeys(DPT_KINDS, 0))
        check(counts == want, f"dpt {label} f32 step {path}: backward "
              f"launches {counts}")
        if flag:
            launched = counts
        res[path] = (loss, torch.cat([p.grad.detach().reshape(-1)
                                      for p in state.model.parameters()]))
        del state
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    err = rel_l2(gk, gp)
    print(f"train step dpt {label} f32 B={batch[0].shape[0]}x{SECONDS}s "
          f"kernel vs plain: loss {lk:.6f} vs {lp:.6f}; gradient rel_l2 "
          f"{err:.3e} (bar {BWD_TOL['float32']:.0e}); kernel path's backward "
          f"launches {launched}", flush=True)
    check(torch.isfinite(gk).all().item() and err <= BWD_TOL["float32"],
          f"dpt {label} f32 step: gradient {err:.3e}")


def phase_dpt_head_widths(torch, dpt):
    """The DPT quality default at the head widths beyond 32 and 64: 2 heads
    of 128 and 16 heads of 16 (B = 256), random weights from seed 0, B=4 x
    4 s. In bf16: one forward, kernel path against plain path within the
    bf16 forward bar, with B7 and B9 once per layer (and B11 twice); one
    train step over three batch seeds as ``dpt_step_medians`` holds it,
    with B8 and B10 once per layer. In f32 (the default compute dtype):
    one forward, kernel path against plain path within the f32 forward bar
    (2e-3), with the same launch counts; and one train step, the kernel
    path's gradient against the plain path's within the f32 step bar
    (``dpt_f32_step_vs_plain``)."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params

    batch = train_batch(torch, 4, 23)
    for heads in (2, 16):
        label = f"d={DPT_B // heads} ({heads} heads)"
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(dpt_config(dtype), dpt_heads=heads)
            sd = init_params(cfg, torch.Generator().manual_seed(0))
            dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
            if dtype == "bfloat16":
                dpt_step_medians(torch, dpt, cfg, sd, (23, 24, 25), label,
                                 ("inter", "intra"), batch)
            else:
                dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)


# (B, m, heads): the attention kernels alone at [8, 25, 128, B] at head
# widths off the cores' 16, 32, 64 and 128, full and on the last shard of
# two: d = 8 (32 heads at B = 256) and 48 (4 heads at B = 192) widened
# with zero columns to 16 and 64; d = 192 (one head at B = 192, two at 384
# on shards) and 256 (one head at B = 256, two at 512 on shards) on the
# route beside the cores
HEAD_WIDTH_CASES = ((256, 1, 32), (256, 2, 32), (192, 1, 4), (192, 2, 4),
                    (192, 1, 1), (384, 2, 2), (256, 1, 1), (512, 2, 2))
# the cotangents (dpt_bwd_fns order) that keep the narrow heads' bits when
# each head of d = 32 (64) on the last shard of two at B = 256 is widened
# with zero columns to 64 (128) and run there with the scale of d: every
# one in f32; in bf16 dx, dgamma and dbeta, while the weight gradients sum
# their rows in chunks wg_wgrad_chunk picks from the operands' widths (at
# [8, 25, 128, 256] dW_qkv 1024 rows a chunk at 3Bq = 384 and at 768,
# dW_out 256 at Bq = 128 and 512 at 256)
HEAD_BITS = {"float32": (0, 1, 2, 3, 4), "bfloat16": (0, 1, 2)}
# (B, heads, m): the device-time cases of phase_dpt_every_head_width:
# d = 48 widened to 64 beside d = 64 at the same 4 heads (the gap is the
# padding), and one head of 256 on the route beside 8 heads of 32; then
# B7p-B10p on the last shard of two at d = 48 (2 heads) and d = 256 (1)
HEAD_TIMING_CASES = ((192, 4, 1), (256, 4, 1), (256, 1, 1), (256, 8, 1),
                     (192, 4, 2), (512, 2, 2))


def head_zero_columns(torch, dpt, failures: list) -> None:
    """The zero-column proof: the attention sublayers' partial kernels at
    [8, 25, 128, 256] (the real key mask) on the last head-group shard of
    two (128 channels: 4 heads of d = 32, or 2 of 64), each head widened
    with zero columns to 2d (``pad_heads``; the widened shard fills B, so
    B and every route chosen by it stay) and run on the 2d core through
    the CUDA branch with the scale of d (``launch_attention(..., d=d)``):
    the forward the d core's bits, and the cotangents of ``HEAD_BITS`` the
    d core's backward bits; bf16 and f32."""
    attn = dpt["inter"]
    m = 2
    for d in (32, 64):
        heads = DPT_B // d // m
        kw = dict(n_heads=heads, partial=True)
        for kind in ("inter", "intra"):
            fused, _ = dpt_fns(dpt, kind)
            fused_b, _ = dpt_bwd_fns(dpt, kind)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                x, g, w, _, _ = dpt_bwd_inputs(torch, kind, dtype, 25, 3199,
                                               seed=7500 + d,
                                               heads=heads * m)
                x, *w = dpt_shard(torch, (x, *w), kind, m, m - 1)
                gamma, beta, w_qkv, w_out, bias = w
                wq2, wo2 = attn.pad_heads(w_qkv, w_out, heads, 2 * d)
                with torch.inference_mode():
                    out = fused(x, gamma, beta, w_qkv.to(dtype),
                                w_out.to(dtype), bias, **kw)
                    out_w = attn.launch_attention(
                        kind, x, gamma, beta, wq2.to(dtype), wo2.to(dtype),
                        bias, d=d, **kw)
                grads = fused_b(x, g, *w, **kw)
                *grads_w, dwq, dwo = attn.launch_attention_bwd(
                    kind, x, g, gamma, beta, wq2, wo2, bias, d=d, **kw)
                grads_w += attn.unpad_heads(dwq, dwo, heads, d)
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(grads_w, grads)]
                names = DPT_GRAD_NAMES[kind]
                fwd_same = torch.equal(out_w, out)
                print(f"dpt {kind} partial {name} heads of {d} widened to "
                      f"{2 * d} (scale of {d}): forward the same bits "
                      f"{fwd_same}; "
                      f"cotangents the same bits {dict(zip(names, same))}",
                      flush=True)
                held = HEAD_BITS[name]
                if not fwd_same or not all(same[i] for i in held):
                    failures.append(
                        f"{kind} {name} heads {d} -> {2 * d}: forward "
                        f"{fwd_same}, {[names[i] for i in held if not same[i]]}"
                        f" moved")


def head_width_timings(torch, dpt, card: str) -> None:
    """Device time per call of B7-B10 (and B7p-B10p on the last shard of
    m) at [8, 25, 128, B] with the real key mask (``HEAD_TIMING_CASES``),
    forward and backward, bf16 and f32, beside its bound (the real d's
    FLOP at 989 TFLOP/s bf16 or 67 TFLOP/s f32 FMA, or the bytes at 3.35
    TB/s) and each launch's share: d = 48 widened to 64 beside d = 64 (the
    gap is the padding); one head of 256 on the route beside 8 heads of
    32."""
    for B, heads, m in HEAD_TIMING_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_F32_FLOPS)
            for kind in ("inter", "intra"):
                fused, _ = dpt_fns(dpt, kind)
                fused_b, _ = dpt_bwd_fns(dpt, kind)
                args, kw, _ = dpt_inputs(torch, kind, dtype, 25, 3199,
                                         seed=7600, heads=heads, B=B)
                x, g, w, _, _ = dpt_bwd_inputs(torch, kind, dtype, 25, 3199,
                                               seed=7600, heads=heads, B=B)
                if m > 1:
                    args = dpt_shard(torch, args, kind, m, m - 1)
                    x, *w = dpt_shard(torch, (x, *w), kind, m, m - 1)
                    kw = dict(n_heads=heads // m, partial=True)
                with torch.inference_mode():
                    ms, split = device_ms(torch, lambda: fused(*args, **kw),
                                          5)
                bound = kernel_bound(*dpt_work(kind, args), peak=peak)
                bms, bsplit = device_ms(
                    torch, lambda: fused_b(x, g, *w, **kw), 3)
                bbound = kernel_bound(*dpt_bwd_work(
                    kind, (x, g, *w), fused_b(x, g, *w, **kw)), peak=peak)
                for what, t, (b, by), parts in (
                        ("forward", ms, bound, split),
                        ("backward", bms, bbound, bsplit)):
                    top = "; ".join(
                        f"{kernel_name(k)} {1e3 * v:.1f}" for k, v in sorted(
                            parts.items(), key=lambda kv: -kv[1])[:6])
                    mode = f" partial m={m}" if m > 1 else ""
                    print(f"timing [{card}] dpt {kind}{mode} {what} [8,25,"
                          f"{DPT_S},{B}] {heads // m} heads of {B // heads} "
                          f"{name}: device "
                          f"{t:.4f} ms, bound {b:.4f} ms ({by}); us by "
                          f"launch: {top}", flush=True)


def phase_dpt_head_width_kernels(torch, dpt) -> dict:
    """B7-B10 and B7p-B10p at head widths off the cores
    (``HEAD_WIDTH_CASES``) against their twins as ``wide_kernels_vs_twins``
    holds them, and the zero-column bits of ``head_zero_columns``. Returns
    the worst max_abs_err per kernel."""
    t0 = time.perf_counter()
    failures = []
    worst = wide_kernels_vs_twins(torch, dpt, failures,
                                  cases=HEAD_WIDTH_CASES,
                                  kinds=("inter", "intra"))
    head_zero_columns(torch, dpt, failures)
    check(not failures, "DPT attention at head widths off the cores "
          "disagrees: " + "; ".join(failures))
    print(f"dpt attention at head widths off the cores: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def phase_dpt_every_head_width(torch, dpt, work: str, data: str,
                               json_dir: str, card: str):
    """The DPT attention at head widths off the cores' 16, 32, 64 and 128:
    each kernel alone against its twin and the zero-column proof
    (``phase_dpt_head_width_kernels``: d = 8, 48 widened with zero
    columns, 192, 256 on the route beside the cores, full and on a shard
    of two); the quality default at
    ``--B 256 --dpt-heads 1`` (one head of 256), random weights from seed
    0, one forward kernel path against plain path in bf16 and f32 and one
    train step (f32 within the step bar, bf16 over three seeds), exact
    launch counts; ``cli train``, ``cli separate`` and ``cli evaluate``
    under ``--use-pallas -1`` at ``--B 96 --dpt-heads 2`` bf16 and ``--B
    256 --dpt-heads 1`` f32 (``wider_cli_path``); ``cli train --B 96
    --dpt-heads 2 --n-model 2`` through B7p-B12p (one head of 48 a shard)
    and its package through ``cli separate --tensor-parallel 2``; and
    ``head_width_timings``."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.ops.cuda import shapes

    t0 = time.perf_counter()
    worst = phase_dpt_head_width_kernels(torch, dpt)
    batch = train_batch(torch, 4, 51)
    label = "--B 256 --dpt-heads 1"
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(dpt_config(dtype), dpt_heads=1)
        check(not shapes.refusals(cfg), f"dpt {label}: refused "
              f"{shapes.refusals(cfg)}")
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
        if dtype == "float32":
            dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)
        else:
            dpt_step_medians(torch, dpt, cfg, sd, (51, 52, 53), label,
                             ("inter", "intra"), batch)
    cli = {f"B{w} h{h} {d}": wider_cli_path(torch, dpt, work, data,
                                            json_dir, w, d, heads=h)
           for w, h, d in ((96, 2, "bfloat16"), (256, 1, "float32"))}
    tp = phase_dpt_tp_train_path(torch, dpt, work, data, json_dir, width=96,
                                 heads=2)
    head_width_timings(torch, dpt, card)
    print(f"dpt head widths phase: worst max_abs_err vs twins "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }, cli "
          f"backward launches {cli}, TP train partial launches {tp}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


WIDE_B = 512   # the widest DPT on the kernels' resident tiles (kWideMax)
# (width, shards): the kernels alone at [8, 25, 128, B], B / 32 heads: B7-B12
# at 512 and 320, and B7p-B12p on the last shard of two at 512
WIDE_CASES = ((WIDE_B, 1), (WIDE_B, 2), (320, 1))


# the bf16 forwards at their rounding points above 256: B6's order bar,
# 1e-3, in full mode; twice that for a partial output, which lacks x: the
# same order noise weighs about twice as much in it (at B = 256
# phase_dpt_partial_vs_twin reads 6.1e-4 on one shard of two of B9, and
# phase_dpt_kernels_vs_twin 3.0e-4 in full mode)
WIDE_ORDER_TOL = {False: 1e-3, True: 2e-3}


def wide_kernels_vs_twins(torch, dpt, failures: list,
                          cases=WIDE_CASES, kinds=DPT_KINDS) -> dict:
    """Each of ``kinds`` of B7-B12 alone (and B7p-B12p on the last shard
    of m) at the ``cases``' (B, m) or (B, m, heads) ([8, 25, 128, B] with
    the real key mask, B / 32 heads where the case names none, F = 1024),
    bf16 and f32, against its twin: the forward within
    4e-2 / 1e-5 on the valid rows (bf16 also at its rounding points,
    ``WIDE_ORDER_TOL``: 2e-3 for a partial output above B = 256), the
    backward as ``compare_cotangents``, and a second backward the same
    bits. Appends what fails; returns the worst max_abs_err per kernel
    name."""
    worst = {}
    for B, m, *named in cases:
        heads = named[0] if named else B // 32
        for kind in kinds:
            fused, twin = dpt_fns(dpt, kind)
            fused_b, twin_b = dpt_bwd_fns(dpt, kind)
            kw = ({} if kind == "ffn" else {"n_heads": heads // m})
            if m > 1:
                kw["partial"] = True
            names = DPT_GRAD_NAMES[kind]
            tag = f"dpt {kind}{' partial' if m > 1 else ''}"
            shard = f", shard {m - 1} of {m}" if m > 1 else ""
            if named:
                shard = f", {heads // m} heads of {B // heads}{shard}"
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                args, _, valid = dpt_inputs(torch, kind, dtype, 25, 3199,
                                            seed=7000 + B + m, heads=heads,
                                            B=B)
                if m > 1:
                    args = dpt_shard(torch, args, kind, m, m - 1)
                with torch.inference_mode():
                    got = fused(*args, **kw)
                    torch.cuda.synchronize()
                    want = twin(*args, **kw)
                rows = valid.reshape(-1)
                got_v = got.reshape(8, -1, B)[:, rows]
                want_v = want.reshape(8, -1, B)[:, rows]
                err = rel_l2(got_v, want_v)
                worst[tag] = max(worst.get(tag, 0.0), (
                    got_v.float() - want_v.float()).abs().max().item())
                at, ok = "", err <= DPT_TOL[name]
                if dtype == torch.bfloat16:
                    with torch.inference_mode():
                        rounded = rounded_forward(dpt, kind, args, kw)
                    order = rel_l2(got_v, rounded.reshape(8, -1, B)[:, rows])
                    bar = WIDE_ORDER_TOL[m > 1 and B > 256]
                    at = (f", at its rounding points {order:.3e} (bar "
                          f"{bar:.0e})")
                    ok = ok and order <= bar
                print(f"{tag} kernel vs twin [8,25,{DPT_S},{B}]{shard} "
                      f"{name}: rel_l2 {err:.3e} (bar {DPT_TOL[name]:.0e})"
                      f"{at}", flush=True)
                if not (ok and torch.isfinite(got_v).all().item()):
                    failures.append(f"{tag} B={B} {name}: {err:.3e}{at}")
                x, g, w, _, valid = dpt_bwd_inputs(torch, kind, dtype, 25,
                                                   3199, seed=7100 + B + m,
                                                   heads=heads, B=B)
                if m > 1:
                    x, *w = dpt_shard(torch, (x, *w), kind, m, m - 1)
                got = fused_b(x, g, *w, **kw)
                again = fused_b(x, g, *w, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    failures.append(f"{tag} B={B} {name}: two backwards "
                                    f"apart")
                exact = twin_b(x.float(), g.float(), *w, **kw)
                same = twin_b(x, g, *w, **kw) if dtype == torch.bfloat16 \
                    else exact
                n_g = len(names)
                if kind == "ffn" and m > 1:   # db_down: zero
                    if got[-1].any().item():
                        failures.append(f"{tag} B={B} {name}: db_down not 0")
                    n_g -= 1
                worst[tag + " bwd"] = max(
                    worst.get(tag + " bwd", 0.0), compare_cotangents(
                        torch, f"{tag} bwd kernel vs twin [8,25,{DPT_S},{B}]"
                        f"{shard} {name}", names[:n_g], got[:n_g],
                        exact[:n_g], same[:n_g], valid, dtype, failures))
    return worst


def kernel_name(key: str) -> str:
    """A profiler key's kernel name with its template arguments, without
    its namespaces and parameters ("attn_lq_kernel<128, false, true>")."""
    import re

    key = key.replace("(anonymous namespace)::", "")
    for name, targs in re.findall(r"(\w+)\s*(<[^()]*>)?\s*\(", key):
        if name != "void":
            return name + targs
    return key


def wide_timings(torch, dpt, card: str, width: int = WIDE_B,
                 narrow: bool = True) -> None:
    """Device time per call of each DPT kernel at [8, 25, 128, width]
    (width / 32 heads of 32; the FFN at [8, 3200, width], F = 1024) with
    the real key mask, forward and backward, full and on one shard of two,
    bf16 and f32, beside its twin's time (CUDA events) and its bound (the
    FLOP at 989 TFLOP/s bf16 or 67 TFLOP/s f32 FMA, or the bytes at 3.35
    TB/s) and each launch's share; with ``narrow``, the f32 B11 and B12 at
    the quality default's width [8, 3200, 256] too."""
    cases = [(width, m, dtype) for dtype in (torch.bfloat16, torch.float32)
             for m in (1, 2)]
    if narrow:
        cases += [(DPT_B, 1, torch.float32)]
    for B, m, dtype in cases:
        name = str(dtype).split(".")[-1]
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        heads = B // 32
        kinds = DPT_KINDS if B == width else ("ffn",)
        for kind in kinds:
            kw = ({} if kind == "ffn" else {"n_heads": heads // m})
            if m > 1:
                kw["partial"] = True
            fused, twin = dpt_fns(dpt, kind)
            fused_b, twin_b = dpt_bwd_fns(dpt, kind)
            args, _, _ = dpt_inputs(torch, kind, dtype, 25, 3199, seed=7300,
                                    heads=heads, B=B)
            x, g, w, _, _ = dpt_bwd_inputs(torch, kind, dtype, 25, 3199,
                                           seed=7300, heads=heads, B=B)
            if m > 1:
                args = dpt_shard(torch, args, kind, m, m - 1)
                x, *w = dpt_shard(torch, (x, *w), kind, m, m - 1)
            with torch.inference_mode():
                ms, split = device_ms(torch, lambda: fused(*args, **kw), 10)
                plain_ms = time_ms(torch, lambda: twin(*args, **kw), 5)
            bound = kernel_bound(*dpt_work(kind, args), peak=peak)
            bms, bsplit = device_ms(torch, lambda: fused_b(x, g, *w, **kw),
                                    5)
            bplain_ms = time_ms(torch, lambda: twin_b(x, g, *w, **kw), 3)
            bbound = kernel_bound(*dpt_bwd_work(
                kind, (x, g, *w), fused_b(x, g, *w, **kw)), peak=peak)
            shape = (f"[8,3200,{B}] F={DPT_F // m}" if kind == "ffn"
                     else f"[8,25,{DPT_S},{B}]")
            mode = f" partial m={m}" if m > 1 else ""
            for what, t, tp, (b, by), parts in (
                    ("forward", ms, plain_ms, bound, split),
                    ("backward", bms, bplain_ms, bbound, bsplit)):
                top = "; ".join(
                    f"{kernel_name(k)} {1e3 * v:.1f}"
                    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))
                print(f"timing [{card}] dpt {kind}{mode} {what} {shape} "
                      f"{name}: device {t:.4f} ms, twin {tp:.4f} ms, bound "
                      f"{b:.4f} ms ({by}); us by launch: {top}", flush=True)


def phase_dpt_wide(torch, dpt, work: str, data: str, json_dir: str,
                   card: str):
    """The DPT at ``--B 512``: 16 heads of 32, F = 1024, 128-frame chunks,
    4 layers, otherwise the quality default, random weights from seed 0;
    its sublayer kernels run their wide routes above 256
    (``csrc/dpt_attn_bwd_wg.cuh``, ``dpt_ffn.cu``, ``dpt_ffn_bwd.cu``, the
    f32 inter cores taking more than 8 heads in turn). Each kernel alone
    against its twin (``wide_kernels_vs_twins``: B7-B12 at B = 512 and
    320, B7p-B12p at 512); in bf16 and f32 one forward (B=4 x 4 s) kernel
    path against plain path within the forward bar, B7 and B9 once per
    layer and B11 twice (``dpt_forward_vs_plain``), and one train step,
    bf16 as ``dpt_step_medians`` holds it over three seeds, f32 within the
    f32 step bar (``dpt_f32_step_vs_plain``), exact launch counts; then
    ``cli train --B 512 --n-model 2`` through B7p-B12p and its package
    through ``cli separate --tensor-parallel 2``
    (``phase_dpt_tp_train_path``); and ``wide_timings``."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.ops.cuda import shapes

    t0 = time.perf_counter()
    failures = []
    worst = wide_kernels_vs_twins(torch, dpt, failures)
    check(not failures, "DPT kernels above 256 disagree with their twins: "
          + "; ".join(failures))
    batch = train_batch(torch, 4, 31)
    label = f"--B {WIDE_B}"
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(dpt_config(dtype), bottleneck=WIDE_B)
        check(cfg.dpt_num_heads == 16 and not shapes.refusals(cfg),
              f"dpt {label}: heads {cfg.dpt_num_heads}, refused "
              f"{shapes.refusals(cfg)}")
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
        if dtype == "bfloat16":
            dpt_step_medians(torch, dpt, cfg, sd, (31, 32, 33), label,
                             DPT_KINDS, batch)
        else:
            dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)
    tp = phase_dpt_tp_train_path(torch, dpt, work, data, json_dir,
                                 width=WIDE_B)
    wide_timings(torch, dpt, card)
    print(f"dpt {label} phase: worst max_abs_err vs twins "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }, TP train "
          f"partial launches {tp}; {time.perf_counter() - t0:.1f} s",
          flush=True)


WIDER_B = 1024   # the DPT the smoke serves and trains past the resident tiles
# (width, shards): the kernels alone at [8, 25, 128, B], B / 32 heads, on
# the routes above 512: B7-B12 at 1024 (the f32 inter cores staging 16 key
# chunks a load) and 576, B7p-B12p on the last shard of two at 1024
WIDER_CASES = ((WIDER_B, 1), (WIDER_B, 2), (576, 1))
# the cotangents (dpt_bwd_fns order) that keep the B = 512 bits when the
# sublayer runs at 576 with 64 zero columns and two zero heads: every one
# in f32; in bf16 dx, dgamma, dbeta (and the FFN's bias gradients), while
# the weight gradients sum their rows in chunks that wg_wgrad_chunk picks
# from the operands' widths (another chunk at the padded width: held by
# the twins' bars; PERF.md §6 names the launch)
WIDER_BITS = {
    ("float32", "inter"): (0, 1, 2, 3, 4),
    ("float32", "intra"): (0, 1, 2, 3, 4),
    ("float32", "ffn"): (0, 1, 2, 3, 4, 5, 6),
    ("bfloat16", "inter"): (0, 1, 2),
    ("bfloat16", "intra"): (0, 1, 2),
    ("bfloat16", "ffn"): (0, 1, 2, 4, 6),
}


def zero_column_operands(torch, args, kind: str, to: int, extra_heads: int):
    """A sublayer's operands padded to ``to`` columns: zero columns of x,
    gamma, beta (and b_down), zero rows and columns of the weights that
    meet them, and in each of q, k and v ``extra_heads`` zero heads of
    32."""
    import torch.nn.functional as F

    B = args[0].shape[-1]
    pad = to - B
    if kind == "ffn":
        x, g_, b_, w_up, b_up, w_down, b_down = args
        return (F.pad(x, (0, pad)), F.pad(g_, (0, pad)), F.pad(b_, (0, pad)),
                F.pad(w_up, (0, 0, 0, pad)), b_up, F.pad(w_down, (0, pad)),
                F.pad(b_down, (0, pad)))
    x, g_, b_, w_qkv, w_out, bias = args
    dq = 32 * extra_heads
    qkv = torch.cat([F.pad(t, (0, dq, 0, pad)) for t in w_qkv.split(B, 1)],
                    dim=1)
    return (F.pad(x, (0, pad)), F.pad(g_, (0, pad)), F.pad(b_, (0, pad)),
            qkv, F.pad(w_out, (0, pad, 0, dq)), bias)


def wider_zero_columns(torch, dpt, failures: list) -> None:
    """The routes above 512 against the resident ones, bit for bit: each
    of B7-B12 at [8, 25, 128, 512] (16 heads of 32, F = 1024; the real key
    mask), and the same sublayer padded to 576 with 64 zero columns and
    two zero heads, run through the CUDA branch with its LN over the first
    Bn = 512 columns (``launch_attention(..., Bn=512)``, the FFN's
    ``_launch_cuda``): the forward the B = 512 bits, and the cotangents of
    ``WIDER_BITS`` the B = 512 backward's bits; bf16 and f32."""
    import torch.nn.functional as F

    for kind in DPT_KINDS:
        fused, _ = dpt_fns(dpt, kind)
        fused_b, _ = dpt_bwd_fns(dpt, kind)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, g, w, kw, _ = dpt_bwd_inputs(torch, kind, dtype, 25, 3199,
                                            seed=7400, heads=16, B=512)
            xw, *ww = zero_column_operands(torch, (x, *w), kind, 576, 2)
            gw = F.pad(g, (0, 64))
            with torch.inference_mode():
                out = fused(x, *w, **kw)
                if kind == "ffn":
                    out_w = dpt["ffn"]._launch_cuda(xw, *ww, Bn=512)
                else:
                    out_w = dpt["inter"].launch_attention(
                        kind, xw, *ww, n_heads=18, Bn=512)
            grads = fused_b(x, g, *w, **kw)
            if kind == "ffn":
                grads_w = dpt["ffn"]._launch_cuda_bwd(xw, gw, *ww, Bn=512)
            else:
                dx, dgam, dbet, dwq, dwo = dpt["inter"].launch_attention_bwd(
                    kind, xw, gw, *ww, n_heads=18, Bn=512)
                dwq = dwq.reshape(512, 3, 576)[:, :, :512].reshape(512, -1)
                grads_w = (dx, dgam, dbet, dwq, dwo[:512])
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(grads_w, grads)]
            names = DPT_GRAD_NAMES[kind]
            fwd_same = torch.equal(out_w, out)
            print(f"dpt {kind} {name} zero columns 512 -> 576 (Bn 512): "
                  f"forward the same bits {fwd_same}; cotangents the same "
                  f"bits {dict(zip(names, same))}", flush=True)
            held = WIDER_BITS[(name, kind)]
            if not fwd_same or not all(same[i] for i in held):
                failures.append(
                    f"{kind} {name} zero columns: forward {fwd_same}, "
                    f"{[names[i] for i in held if not same[i]]} moved")


def phase_dpt_wider_kernels(torch, dpt) -> dict:
    """B7-B12 and B7p-B12p above 512 (``WIDER_CASES``) against their twins
    as ``wide_kernels_vs_twins`` holds them, and the zero-column bits of
    ``wider_zero_columns``. Returns the worst max_abs_err per kernel."""
    t0 = time.perf_counter()
    failures = []
    worst = wide_kernels_vs_twins(torch, dpt, failures, cases=WIDER_CASES)
    wider_zero_columns(torch, dpt, failures)
    check(not failures, "DPT kernels above 512 disagree: "
          + "; ".join(failures))
    print(f"dpt kernels above 512: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return worst


def wider_cli_path(torch, dpt, work: str, data: str, json_dir: str,
                   width: int, dtype: str, heads: int = 0) -> dict:
    """``cli train --separator dpt --B width --dpt-heads heads
    --compute-dtype dtype --use-pallas -1`` (0 heads: B / 32) on the
    corpus of ``make_corpus`` (one epoch of 4
    steps at batch 8 x 4 s and a cv pass), then ``cli separate`` and ``cli
    evaluate`` of its package under auto: every loss finite; per step 4
    B7, 4 B9 and 8 B11 and 4 B8, 4 B10 and 8 B12, per cv or served batch
    the forwards; the separated wavs finite and of the mixtures' lengths,
    SI-SNRi finite. Returns the train run's backward launches."""
    import contextlib
    import io

    from convtasnet_tpu_torch import cli

    cfg = dpt_config(dtype)
    per_batch = {"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                 "ffn": 2 * cfg.dpt_layers}
    n_cv = 2
    label = f"--B {width} --dpt-heads {heads} {dtype}"
    tag = f"B{width}_h{heads}_{dtype}"
    out = os.path.join(work, f"exp_dpt_{tag}")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    reset_dpt_all(dpt)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--separator", "dpt", "--B",
            str(width), "--dpt-heads", str(heads), "--compute-dtype", dtype,
            "--use-pallas", "-1", "--epochs", "1", "--batch-size", "8",
            "--print-freq", "1"])
    torch.cuda.synchronize()
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    wall = time.perf_counter() - t0
    fwd, bwd = dpt_launches(dpt), dpt_bwd_launches(dpt)
    check(rc == 0, f"cli train {label} returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    check(n_steps == 4 and all(math.isfinite(v) for v in losses),
          f"cli train {label}: losses {losses}")
    want_fwd = {k: v * (n_steps + n_cv) for k, v in per_batch.items()}
    want_bwd = {k: v * n_steps for k, v in per_batch.items()}
    check(fwd == want_fwd and bwd == want_bwd, f"cli train {label}: "
          f"launches {fwd} / {bwd}, expected {want_fwd} / {want_bwd}")
    pkg = os.path.join(out, "final.ckpt")
    mix_dir = os.path.join(data, "cv", "mix")
    sep_dir = os.path.join(work, f"sep_dpt_{tag}")
    reset_dpt_all(dpt)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["separate", "--model-path", pkg, "--mix-dir", mix_dir,
                       "--out-dir", sep_dir, "--batch-size", str(n_cv),
                       "--device", "cuda", "--use-pallas", "-1"])
    torch.cuda.synchronize()
    sep = dpt_launches(dpt)
    check(rc == 0 and sep == per_batch, f"cli separate {label}: rc {rc}, "
          f"launches {sep}, expected {per_batch}")
    check_wavs(sep_dir, mix_dir)
    reset_dpt_all(dpt)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["evaluate", "--model-path", pkg, "--data-dir",
                       os.path.join(json_dir, "cv"), "--batch-size",
                       str(n_cv), "--use-pallas", "-1"])
    torch.cuda.synchronize()
    ev = dpt_launches(dpt)
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and ev == per_batch and math.isfinite(result["si_snri"]),
          f"cli evaluate {label}: rc {rc}, launches {ev}, {result}")
    print(f"cli train / separate / evaluate {label} (--use-pallas -1): "
          f"{n_steps} steps, losses {[round(v, 4) for v in losses]}, "
          f"launches {fwd} / {bwd}; separate {sep}; evaluate {ev}, "
          f"{result}; train {wall:.1f} s, all {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return bwd


def wider_matmuls(torch, card: str, width: int) -> None:
    """``torch.matmul`` at the products of the DPT sublayers at [8, 25,
    128, width] (R = 25,600 rows; F = 1024), bf16 and f32, device time per
    call: the QKV product [R, B] x [B, 3B], the out product [R, B] x [B,
    B], the FFN's [R, B] x [B, F] and [R, F] x [F, B]: the library's time
    for the projections the kernels run."""
    R, B, F = 8 * 25 * DPT_S, width, DPT_F
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for label, (m, k, n) in (("qkv", (R, B, 3 * B)), ("out", (R, B, B)),
                                 ("ffn up", (R, B, F)),
                                 ("ffn down", (R, F, B))):
            a = torch.randn(m, k, device="cuda").to(dtype)
            b = torch.randn(k, n, device="cuda").to(dtype)
            ms, _ = device_ms(torch, lambda: torch.matmul(a, b), 10)
            print(f"timing [{card}] torch.matmul {label} [{m}, {k}] x [{k}, "
                  f"{n}] {name}: device {ms:.4f} ms", flush=True)


def phase_dpt_wider(torch, dpt, work: str, data: str, json_dir: str,
                    card: str):
    """The DPT above 512 channels, on the routes beside the resident tiles
    (``csrc/dpt_attn_bwd_wg.cuh``'s streamed LQ and F1, launch_qkv_rows,
    ln_bwd_wide_kernel, the f32 inter cores' smaller key staging): each
    kernel alone against its twin and the zero-column bits
    (``phase_dpt_wider_kernels``); the quality default at ``--B 1024``
    (32 heads of 32, F = 1024) and ``--B 576`` (18 heads), random weights
    from seed 0, one forward kernel path against plain path in bf16 and
    f32 (B=4 x 4 s; 4 B7, 4 B9, 8 B11), one f32 train step against plain
    at both widths and the bf16 step over three seeds at 1024 (4 B8, 4 B10,
    8 B12); ``cli train``, ``cli separate`` and ``cli evaluate`` under
    ``--use-pallas -1`` at ``--B 1024`` bf16 and ``--B 576`` f32
    (``wider_cli_path``); ``cli train --B 1024 --n-model 2`` through
    B7p-B12p and its package through ``cli separate --tensor-parallel 2``;
    and ``wide_timings`` at 1024 with ``torch.matmul`` at the products'
    shapes."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.ops.cuda import shapes

    t0 = time.perf_counter()
    worst = phase_dpt_wider_kernels(torch, dpt)
    batch = train_batch(torch, 4, 41)
    for width in (WIDER_B, 576):
        label = f"--B {width}"
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(dpt_config(dtype), bottleneck=width)
            check(cfg.dpt_num_heads == width // 32
                  and not shapes.refusals(cfg),
                  f"dpt {label}: heads {cfg.dpt_num_heads}, refused "
                  f"{shapes.refusals(cfg)}")
            sd = init_params(cfg, torch.Generator().manual_seed(0))
            dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
            if dtype == "float32":
                dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)
            elif width == WIDER_B:
                dpt_step_medians(torch, dpt, cfg, sd, (41, 42, 43), label,
                                 DPT_KINDS, batch)
    cli = {f"B{w} {d}": wider_cli_path(torch, dpt, work, data, json_dir, w, d)
           for w, d in ((WIDER_B, "bfloat16"), (576, "float32"))}
    tp = phase_dpt_tp_train_path(torch, dpt, work, data, json_dir,
                                 width=WIDER_B)
    wide_timings(torch, dpt, card, width=WIDER_B, narrow=False)
    wider_matmuls(torch, card, WIDER_B)
    print(f"dpt above 512 phase: worst max_abs_err vs twins "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }, cli "
          f"backward launches {cli}, TP train partial launches {tp}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# (width, shards): the widths off 64 that the wrappers zero-pad
# (dpt_attention.pad_attention, dpt_ffn.pad_ffn), B / 32 heads: B7-B12 at
# B = 96, 160 and 480 (480 pads to 512, the wide routes), and B7p-B12p on
# the last shard of B = 256 over 8 (32 channels, one head) and of B = 192
# over 2 (96 channels, 3 heads)
PADDED_CASES = ((96, 1), (160, 1), (480, 1), (256, 8), (192, 2))
PADDED_B = 96


def phase_dpt_padded(torch, dpt, work: str, data: str, json_dir: str):
    """The DPT widths off the kernels' 64-column tile: the wrappers pad B
    with zero columns (x, gamma, beta and the weights' rows and columns
    that meet them) and a head group's width B / m with whole zero heads,
    and the kernels take each LN's width (their ``Bn``) apart from the
    padded one. Each kernel alone against its unpadded twin
    (``wide_kernels_vs_twins`` at ``PADDED_CASES``); the DPT quality
    default at ``--B 96`` (3 heads of 32, random weights from seed 0, B=4
    x 4 s): one forward in bf16 and f32, kernel path against plain path
    within the forward bar with B7 and B9 once per layer and B11 twice
    (``dpt_forward_vs_plain``), and one f32 train step within the f32 step
    bar (``dpt_f32_step_vs_plain``; auto mode steps it in bf16,
    ``phase_auto_padded``); then ``cli train --B 192 --n-model 2`` (6
    heads, 3 a shard of 96 channels) through B7p-B12p and its package
    through ``cli separate --tensor-parallel 2``
    (``phase_dpt_tp_train_path``), launches exact."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.ops.cuda import shapes

    t0 = time.perf_counter()
    failures = []
    worst = wide_kernels_vs_twins(torch, dpt, failures, PADDED_CASES)
    check(not failures, "DPT kernels at widths off 64 disagree with their "
          "twins: " + "; ".join(failures))
    batch = train_batch(torch, 4, 41)
    label = f"--B {PADDED_B}"
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(dpt_config(dtype), bottleneck=PADDED_B)
        check(cfg.dpt_num_heads == 3 and not shapes.refusals(cfg),
              f"dpt {label}: heads {cfg.dpt_num_heads}, refused "
              f"{shapes.refusals(cfg)}")
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
        if dtype == "float32":
            dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)
    tp = phase_dpt_tp_train_path(torch, dpt, work, data, json_dir, width=192)
    print(f"dpt widths off 64 phase: worst max_abs_err vs twins "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }, TP train "
          f"at B=192 partial launches {tp}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_dpt_chunk256_step(torch, dpt):
    """One bf16 train step (loss and gradients) of the DPT quality default
    with 256-frame chunks (``--dpt-chunk 256``) and with 320-frame chunks
    (past the f32 intra kernels' first designs), B=4 x 4 s, kernel path
    against plain path from the same init and batches, over three batch
    seeds as ``dpt_step_medians`` holds them; the intra backward kernel
    runs at S = 256 and 320, once per layer. One seed's distance is a
    draw: at S = 320 and seed 13 it reads 0.164 on the kernel path and
    0.204 with B9 replaced by its plain twin (an NVIDIA H100 80GB HBM3 at
    700 W). Also at S = 320 one bf16 forward, kernel path against plain
    path within the bf16 forward bar (``dpt_forward_vs_plain``); and the
    f32 model (the default compute dtype) at S = 320, whose intra kernels
    run on their row-statistics core: one forward within the f32 forward
    bar (2e-3) and one train step's gradient within the f32 step bar
    (``dpt_f32_step_vs_plain``), exact launch counts."""
    import dataclasses

    from convtasnet_tpu_torch.models.conv_tasnet import init_params

    batch = train_batch(torch, 4, 13)
    for chunk, dtype in ((256, "bfloat16"), (320, "bfloat16"),
                         (320, "float32")):
        cfg = dataclasses.replace(dpt_config(dtype), dpt_chunk=chunk)
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        label = f"--dpt-chunk {chunk}"
        if chunk == 320:
            dpt_forward_vs_plain(torch, dpt, cfg, sd, batch[0], label)
        if dtype == "bfloat16":
            dpt_step_medians(torch, dpt, cfg, sd, (13, 14, 15), label,
                             ("intra",), batch)
        else:
            dpt_f32_step_vs_plain(torch, dpt, cfg, sd, batch, label)


def phase_intra_f32_long(torch, dpt):
    """B9 and B10 in f32 above 256 frames, on their row-statistics core
    (``csrc/dpt_intra_rowstat.cuh``), against their exact twins at the
    quality default's widths with the key mask of 3199 real frames (4 s):
    head width 32 at S = 320 ([8, 10, 320, 256]) and 512 ([8, 7, 512,
    256]), head widths 16 and 128 at S = 320, and B9p / B10p on the last
    shard of m = 2 at S = 320; the forward and every cotangent (dx on the
    valid rows) within the f32 DPT bars (1e-5), and each backward twice to
    the same bits. Every case is printed before the phase fails."""
    fused, twin = dpt_fns(dpt, "intra")
    fused_b, twin_b = dpt_bwd_fns(dpt, "intra")
    failures = []
    for S, heads, m in ((320, 8, 1), (512, 8, 1), (320, 16, 1), (320, 2, 1),
                        (320, 8, 2)):
        n = -(-3199 // S)
        args, kw, valid = dpt_inputs(torch, "intra", torch.float32, n, 3199,
                                     seed=7300 + S + heads, S=S, heads=heads)
        x, g, w, bkw, _ = dpt_bwd_inputs(torch, "intra", torch.float32, n,
                                         3199, seed=7400 + S + heads, S=S,
                                         heads=heads)
        if m > 1:
            args = dpt_shard(torch, args, "intra", m, m - 1)
            w = list(dpt_shard(torch, (x, *w), "intra", m, m - 1)[1:])
            kw = bkw = dict(n_heads=heads // m, partial=True)
        rows = valid.reshape(-1)
        with torch.inference_mode():
            got = fused(*args, **kw)
            torch.cuda.synchronize()
            want = twin(*args, **kw)
        fwd = rel_l2(got.reshape(8, -1, DPT_B)[:, rows],
                     want.reshape(8, -1, DPT_B)[:, rows])
        got_b = fused_b(x, g, *w, **bkw)
        again = fused_b(x, g, *w, **bkw)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got_b, again))
        exact = twin_b(x, g, *w, **bkw)
        errs = {}
        for i, name in enumerate(DPT_GRAD_NAMES["intra"]):
            q, e = got_b[i], exact[i]
            if i == 0:
                q, e = (v.reshape(8, -1, DPT_B)[:, rows] for v in (q, e))
            errs[name] = (rel_l2(q, e) if torch.isfinite(q).all().item()
                          else math.inf)
        top = max(errs, key=errs.get)
        label = (f"dpt intra f32 row-statistics core [8,{n},{S},{DPT_B}] "
                 f"d={DPT_B // heads}" + (f" m={m}" if m > 1 else ""))
        print(f"{label}: forward kernel vs twin rel_l2 {fwd:.3e} (bar "
              f"{DPT_TOL['float32']:.0e}); backward vs exact "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bar {DPT_BWD_TOL_F32:.0e}); backward twice the same "
              f"bits: {same}", flush=True)
        if not (fwd <= DPT_TOL["float32"] and errs[top] <= DPT_BWD_TOL_F32
                and same):
            failures.append(f"{label}: forward {fwd:.3e}, backward "
                            f"{errs[top]:.3e} ({top}), same bits {same}")
    check(not failures, "f32 intra kernels above 256 frames: "
          + "; ".join(failures))


def phase_dpt_chunk512_f32(torch, dpt, work: str, data: str, json_dir: str):
    """The DPT quality default in f32 (the default compute dtype) with
    512-frame chunks (``--dpt-chunk 512``; at 4 s, n = 7 chunks), whose
    intra sublayers run B9 and B10 on their row-statistics core:
    ``cli train`` in process on the corpus of ``make_corpus``, one epoch
    of 4 steps at batch 8 x 4 s and a cv pass, every loss finite, per step
    4 / 4 / 8 launches of the inter, intra and FFN forward kernels and of
    their backward kernels, the cv batches forward only; then ``separate``
    with its package on the cv mixtures through the kernels (one batch,
    4 / 4 / 8 launches) and through the plain ops, the separated wavs
    within the f32 forward bar (2e-3) of each other."""
    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav
    from convtasnet_tpu_torch.infer.separate import separate

    cfg = dpt_config("float32")
    per_step = {"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                "ffn": 2 * cfg.dpt_layers}
    n_cv = 2
    out = os.path.join(work, "exp_dpt_chunk512")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    reset_dpt_all(dpt)
    t0 = time.perf_counter()
    rc = cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cuda", "--separator", "dpt", "--compute-dtype",
        "float32", "--dpt-chunk", "512", "--use-pallas", "1", "--epochs",
        "1", "--batch-size", "8", "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = dpt_launches(dpt), dpt_bwd_launches(dpt)
    check(rc == 0, f"cli train --dpt-chunk 512 f32 returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train --separator dpt --dpt-chunk 512 (f32, --use-pallas 1):"
          f" {n_steps} steps, losses {[round(x, 4) for x in losses]}, "
          f"forward launches {fwd}, backward launches {bwd}, {wall:.1f} s "
          f"wall", flush=True)
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    want_bwd = {k: v * n_steps for k, v in per_step.items()}
    want_fwd = {k: v * (n_steps + n_cv) for k, v in per_step.items()}
    check(bwd == want_bwd and fwd == want_fwd,
          f"--dpt-chunk 512 f32: forward launches {fwd} (expected "
          f"{want_fwd}), backward {bwd} (expected {want_bwd})")
    pkg = os.path.join(out, "final.ckpt")
    mix_dir = os.path.join(data, "cv", "mix")
    wavs = {}
    for path, flag in (("kernel", None), ("plain", False)):
        sep_dir = os.path.join(work, f"sep_chunk512_{path}")
        reset_dpt_all(dpt)
        n = separate(pkg, sep_dir, mix_dir=mix_dir, batch_size=n_cv,
                     device="cuda", use_pallas=flag)
        torch.cuda.synchronize()
        sep = dpt_launches(dpt)
        want = per_step if flag is None else dict.fromkeys(DPT_KINDS, 0)
        print(f"separate --dpt-chunk 512 f32 {path} path: {n} utterances, "
              f"launches {sep} (expected {want})", flush=True)
        check(n == n_cv and sep == want,
              f"separate --dpt-chunk 512 {path}: {n} utterances, {sep}")
        check_wavs(sep_dir, mix_dir)
        wavs[path] = np.concatenate([
            read_wav(os.path.join(sep_dir, f))[0]
            for f in sorted(os.listdir(sep_dir)) if "_s" in f])
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    err = float(np.linalg.norm(wavs["kernel"] - wavs["plain"])
                / np.linalg.norm(wavs["plain"]))
    print(f"separate --dpt-chunk 512 f32: kernel vs plain wavs rel_l2 "
          f"{err:.3e} (bar {TOL['float32']:.0e})", flush=True)
    check(err <= TOL["float32"], f"--dpt-chunk 512 f32 wavs: {err:.3e}")


def phase_dpt_serving(torch, dpt, work: str):
    """``cli separate`` and ``cli evaluate`` on a DPT inference package
    (quality default, bf16, random weights from seed 0) over 8 seeded
    two-source utterances of 3-6 s, batch 4: the kernels launched in each
    run, every separated wav finite and of the mixture's length, SI-SNRi
    finite and the kernel path's within 0.05 dB of the plain path's.
    Returns the kernel launches of the ``cli separate`` run."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.train.checkpoint import save_inference_package

    cfg = dpt_config()
    pkg = os.path.join(work, "dpt_bf16.pt")
    save_inference_package(pkg, cfg,
                           init_params(cfg, torch.Generator().manual_seed(0)))
    data = os.path.join(work, "dpt_corpus")
    n_utt, batch = 8, 4
    write_corpus(data, "tt", n_utt, np.random.default_rng(2), 3.0, 6.0)
    json_dir = os.path.join(work, "dpt_json")
    check(cli.main(["preprocess", "--data-dir", data, "--out-dir",
                    json_dir]) == 0, "preprocess failed")
    mix_dir = os.path.join(data, "tt", "mix")
    out_dir = os.path.join(work, "dpt_sep")
    reset_dpt_all(dpt)
    check(cli.main(["separate", "--model-path", pkg, "--mix-dir", mix_dir,
                    "--out-dir", out_dir, "--batch-size", str(batch)]) == 0,
          "cli separate failed")
    torch.cuda.synchronize()
    sep_counts = dpt_launches(dpt)
    n_fwd = -(-n_utt // batch)
    want = {"inter": cfg.dpt_layers * n_fwd, "intra": cfg.dpt_layers * n_fwd,
            "ffn": 2 * cfg.dpt_layers * n_fwd}
    check_wavs(out_dir, mix_dir)
    print(f"cli separate, DPT package bf16: {n_utt} utterances in {n_fwd} "
          f"batches, launches {sep_counts} (expected {want})", flush=True)
    check(sep_counts == want, f"cli separate launched {sep_counts}")

    results = {}
    for path, flag in (("kernel", "-1"), ("plain", "0")):
        reset_dpt_all(dpt)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["evaluate", "--model-path", pkg, "--data-dir",
                           os.path.join(json_dir, "tt"), "--batch-size",
                           str(batch), "--use-pallas", flag])
        torch.cuda.synchronize()
        counts = dpt_launches(dpt)
        check(rc == 0, f"cli evaluate ({path}) returned {rc}")
        results[path] = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"cli evaluate, DPT package bf16, {path} path: "
              f"{results[path]}, launches {counts}", flush=True)
        check(counts == (want if path == "kernel"
                         else dict.fromkeys(DPT_KINDS, 0)),
              f"cli evaluate ({path}) launched {counts}")
    k, p = results["kernel"]["si_snri"], results["plain"]["si_snri"]
    check(math.isfinite(k) and math.isfinite(p), "non-finite SI-SNRi")
    check(abs(k - p) <= 0.05, f"SI-SNRi kernel {k:.4f} vs plain {p:.4f} dB")
    return sep_counts


# dual-path tensor parallelism at the quality default: its 8 heads and FFN
# width 1024 over m shards, so the partial kernels run at Bq = 256 / m with
# 8 / m heads and F/m = 1024 / m (m = 2: 128, 4 heads, 512; m = 4: 64, 2
# heads, 256)
DPT_TP_SHARDS = (2, 4)


def dpt_shard(torch, args, kind: str, m: int, s: int):
    """Shard s of m of a full sublayer's operands, cut as
    ``parallel/dpt_tp.dpt_tp_variables`` cuts the weights: the q, k and v
    columns of head group s and those rows of W_out; the FFN's hidden
    slice s (W_up's columns with b_up, W_down's rows)."""
    if kind == "ffn":
        x, g_, b_, w_up, b_up, w_down, b_down = args
        fq = w_up.shape[1] // m
        cut = slice(s * fq, (s + 1) * fq)
        return (x, g_, b_, w_up[:, cut].contiguous(), b_up[cut].contiguous(),
                w_down[cut].contiguous(), b_down)
    x, g_, b_, w_qkv, w_out, bias = args
    B = x.shape[-1]
    bq = B // m
    cut = slice(s * bq, (s + 1) * bq)
    q, k, v = w_qkv.split(B, dim=1)
    return (x, g_, b_, torch.cat([q[:, cut], k[:, cut], v[:, cut]], dim=1),
            w_out[cut].contiguous(), bias)


def dpt_partial_kw(kind: str, m: int) -> dict:
    return dict(partial=True, **({} if kind == "ffn"
                                 else {"n_heads": DPT_HEADS // m}))


def reset_dpt_all(dpt):
    """Every DPT kernel's counts, full and partial, forward and backward,
    to 0."""
    for kind in DPT_KINDS:
        for fn in (dpt_fns(dpt, kind)[0], dpt_bwd_fns(dpt, kind)[0]):
            fn.launches = fn.partial_launches = 0


def dpt_partial_counts(dpt) -> dict:
    """The partial kernels' launches by name, and every full-mode launch of
    the DPT kernels summed (``full``)."""
    out = {}
    full = 0
    for kind in DPT_KINDS:
        for sfx, fn in (("", dpt_fns(dpt, kind)[0]),
                        ("_bwd", dpt_bwd_fns(dpt, kind)[0])):
            out[kind + sfx] = fn.partial_launches
            full += fn.launches
    out["full"] = full
    return out


def dpt_partial_want(m: int, layers: int, fwd: int, bwd: int) -> dict:
    """Expected partial launches over m shards of ``layers`` layers: ``fwd``
    forwards and ``bwd`` backwards, each with m launches per attention
    sublayer of a kind and 2m per FFN; no full-mode launch."""
    per = {"inter": layers, "intra": layers, "ffn": 2 * layers}
    return {**{k: m * v * fwd for k, v in per.items()},
            **{f"{k}_bwd": m * v * bwd for k, v in per.items()}, "full": 0}


def phase_dpt_partial_vs_twin(torch, dpt):
    """The partial kernels B7p-B12p (``partial=True``: one shard's head
    group or hidden slice, the projection alone) against their partial
    twins at [8, 25, 128, 256] with the real key mask, on the last shard of
    m = 2 and 4, bf16 and f32, at the DPT bars (forward 4e-2 / 1e-5 on the
    valid rows, and in bf16 within 1e-3 of the forward at the kernels'
    rounding points; backward as ``compare_cotangents``, the FFN's db_down
    all zero); then the Megatron identity in f32: the m shards' partials
    summed plus the residual (plus b_down) against the full kernel, and
    their backwards' dx summed plus g, dgamma and dbeta summed, against
    the full backward, within 1e-5. Every case is printed before the phase
    fails; returns the worst max_abs_err per partial kernel."""
    worst = {f"{k}{sfx}": 0.0 for k in DPT_KINDS for sfx in ("", "_bwd")}
    failures = []
    t0 = time.perf_counter()
    for m in DPT_TP_SHARDS:
        for kind in DPT_KINDS:
            fused, twin = dpt_fns(dpt, kind)
            fused_b, twin_b = dpt_bwd_fns(dpt, kind)
            kwp = dpt_partial_kw(kind, m)
            names = DPT_GRAD_NAMES[kind]
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                args, _, valid = dpt_inputs(torch, kind, dtype, 25, 3199,
                                            seed=6000 + m)
                sh = dpt_shard(torch, args, kind, m, m - 1)
                with torch.inference_mode():
                    got = fused(*sh, **kwp)
                    torch.cuda.synchronize()
                    want = twin(*sh, **kwp)
                rows = valid.reshape(-1)
                got_v = got.reshape(8, -1, DPT_B)[:, rows]
                want_v = want.reshape(8, -1, DPT_B)[:, rows]
                err = rel_l2(got_v, want_v)
                worst[kind] = max(worst[kind], (got_v.float() - want_v.float())
                                  .abs().max().item())
                finite = torch.isfinite(got_v).all().item()
                at, order = "", 0.0
                if dtype == torch.bfloat16:
                    with torch.inference_mode():
                        rounded = rounded_forward(dpt, kind, sh, kwp)
                    order = rel_l2(got_v, rounded.reshape(8, -1, DPT_B)[:, rows])
                    at = (f", at its rounding points {order:.3e} (bar "
                          f"{TP_ORDER_TOL[name]:.0e})")
                print(f"dpt {kind} partial kernel vs twin, shard {m - 1} of "
                      f"{m} [8,25,{DPT_S},{DPT_B}] {name}: rel_l2 {err:.3e} "
                      f"(bar {DPT_TOL[name]:.0e}){at}", flush=True)
                if (not finite or not err <= DPT_TOL[name]
                        or not order <= TP_ORDER_TOL[name]):
                    failures.append(f"{kind} m={m} {name}: {err:.3e}{at}")
                x, g, w, _, valid = dpt_bwd_inputs(torch, kind, dtype, 25,
                                                   3199, seed=6100 + m)
                x, *w = dpt_shard(torch, (x, *w), kind, m, m - 1)
                got = fused_b(x, g, *w, **kwp)
                torch.cuda.synchronize()
                exact = twin_b(x.float(), g.float(), *w, **kwp)
                same = twin_b(x, g, *w, **kwp) if dtype == torch.bfloat16 \
                    else exact
                n_g = len(names)
                if kind == "ffn":   # db_down: zero, not a column sum
                    if got[-1].any().item():
                        failures.append(f"ffn m={m} {name}: db_down not 0")
                    n_g -= 1
                worst[kind + "_bwd"] = max(
                    worst[kind + "_bwd"], compare_cotangents(
                        torch, f"dpt {kind} partial bwd kernel vs twin, shard "
                        f"{m - 1} of {m} [8,25,{DPT_S},{DPT_B}] {name}",
                        names[:n_g], got[:n_g], exact[:n_g], same[:n_g],
                        valid, dtype, failures))
            # the Megatron identity, f32
            args, kw, valid = dpt_inputs(torch, kind, torch.float32, 25,
                                         3199, seed=6200 + m)
            rows = valid.reshape(-1)
            with torch.inference_mode():
                full = fused(*args, **kw)
                acc = args[0] + sum(fused(*dpt_shard(torch, args, kind, m, s),
                                          **kwp) for s in range(m))
            if kind == "ffn":
                acc = acc + args[-1]
            e_fwd = rel_l2(acc.reshape(8, -1, DPT_B)[:, rows],
                           full.reshape(8, -1, DPT_B)[:, rows])
            x, g, w, kw, valid = dpt_bwd_inputs(torch, kind, torch.float32,
                                                25, 3199, seed=6300 + m)
            full = fused_b(x, g, *w, **kw)
            parts = [fused_b(x, g, *dpt_shard(torch, (x, *w), kind, m, s)[1:],
                             **kwp) for s in range(m)]
            dx = g + sum(p[0] for p in parts)
            e_bwd = max([rel_l2(dx.reshape(8, -1, DPT_B)[:, rows],
                                full[0].reshape(8, -1, DPT_B)[:, rows])]
                        + [rel_l2(sum(p[i] for p in parts), full[i])
                           for i in (1, 2)])
            print(f"dpt {kind} Megatron identity over {m} shards f32: the "
                  f"partials summed + residual vs the full kernel rel_l2 "
                  f"{e_fwd:.3e}; dx, dgamma, dbeta summed vs the full "
                  f"backward max {e_bwd:.3e} (bar {DPT_TOL['float32']:.0e})",
                  flush=True)
            if not (e_fwd <= DPT_TOL["float32"] and e_bwd <= DPT_BWD_TOL_F32):
                failures.append(f"{kind} m={m} identity: forward {e_fwd:.3e}"
                                f", backward {e_bwd:.3e}")
    print(f"dpt partial kernels vs twins: {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(not failures, "DPT partial kernels disagree: " + "; ".join(failures))
    return worst


def randomize_affines(torch, model) -> None:
    """Moves every bias and norm affine of ``model`` off its init (biases
    0, gamma 1, beta 0) by 0.1 x a seeded normal."""
    g = torch.Generator(device="cuda").manual_seed(10)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "gamma", "beta")):
                p.add_(0.1 * torch.randn(p.shape, generator=g, device="cuda"))


def phase_dpt_tp_forward(torch, dpt):
    """``tp_forward`` of the DPT quality default (random weights from seed
    0, with every bias and norm affine moved off its init by 0.1 x a
    normal, so a down bias added once per shard shows) at B=8 x 4 s over
    two and four shards on cuda:0, bf16 and f32, routed to
    ``dpt_tp_forward``: per forward m x (4 B7p, 4 B9p, 8 B11p) and no
    full-mode launch, finite, within 4e-2 (bf16) and 1e-5 (f32) of the
    unsharded kernel path."""
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    t0 = time.perf_counter()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    for dtype in ("bfloat16", "float32"):
        cfg = dpt_config(dtype)
        model = ConvTasNet(cfg, use_pallas=True, device="cuda",
                           generator=torch.Generator().manual_seed(0)).eval()
        randomize_affines(torch, model)
        with torch.inference_mode():
            want = model(mix)
            sd = model.state_dict()
            for m in DPT_TP_SHARDS:
                devices = shard_devices(m, "cuda")
                reset_dpt_all(dpt)
                got = tp_forward(cfg, sd, mix, devices)
                torch.cuda.synchronize()
                counts = dpt_partial_counts(dpt)
                err = rel_l2(got, want)
                exp = dpt_partial_want(m, cfg.dpt_layers, 1, 0)
                print(f"tp_forward DPT quality default B=8x{SECONDS}s {dtype} "
                      f"over {m} shards on "
                      f"{sorted({str(d) for d in devices})}: vs the unsharded "
                      f"kernel path rel_l2 {err:.3e} (bar "
                      f"{DPT_TOL[dtype]:.0e}); launches {counts}", flush=True)
                check(counts == exp, f"dpt tp_forward {dtype} m={m} launched "
                      f"{counts}, expected {exp}")
                check(torch.isfinite(got).all().item()
                      and got.shape == want.shape,
                      f"dpt tp_forward {dtype} m={m}: bad output")
                check(err <= DPT_TOL[dtype], f"dpt tp_forward {dtype} m={m}: "
                      f"{err:.3e}")
        del model
    print(f"dpt tp_forward phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_dpt_tp_train_path(torch, dpt, work: str, data: str, json_dir: str,
                            width: int = DPT_B, heads: int = 0):
    """``cli train --separator dpt --n-model 2 --use-pallas 1`` at the DPT
    quality default (or at ``--B width``, B / 32 heads or ``--dpt-heads
    heads``), bf16, on the
    corpus of ``make_corpus`` (one epoch of 4
    steps at batch 8 and a cv pass): every loss finite, its placement line
    printed, the partial kernels launched 2 x (4, 4, 8) times per step
    (forward and backward) and per cv batch (forward), no full-mode launch;
    then its package served through ``cli separate --tensor-parallel 2``
    (2 x (4, 4, 8) partial forwards per batch) against the unsharded
    ``cli separate`` (4, 4, 8 full-mode launches): finite wavs within the
    bf16 forward bar. Returns the partial launch counts of the train run."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav

    import dataclasses

    cfg = dataclasses.replace(dpt_config(), bottleneck=width,
                              dpt_heads=heads)
    n_cv, m = 2, 2
    tag = f"B{width}" + (f"_h{heads}" if heads else "")
    out = os.path.join(work, f"exp_dpt_tp_{tag}")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    buf = io.StringIO()
    reset_dpt_all(dpt)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--separator", "dpt", "--compute-dtype",
            "bfloat16", "--use-pallas", "1", "--n-model", str(m), "--B",
            str(width), "--dpt-heads", str(heads), "--epochs", "1",
            "--batch-size", "8", "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dpt_partial_counts(dpt)
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    check(rc == 0, f"cli train --separator dpt --n-model {m} returned {rc}")
    placement = buf.getvalue().splitlines()[0]
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train --separator dpt --n-model {m} --B {width} "
          f"--dpt-heads {heads} (bf16, "
          f"--use-pallas 1; {placement}): {n_steps} steps, losses "
          f"{[round(x, 4) for x in losses]}, cv loss "
          f"{[r['loss'] for r in records if r.get('split') == 'valid']}, "
          f"partial launches {counts}, {wall:.1f} s wall", flush=True)
    check(placement.startswith(f"tensor parallel over {m} shards"),
          f"no placement line: {placement!r}")
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    want = dpt_partial_want(m, cfg.dpt_layers, n_steps + n_cv, n_steps)
    check(counts == want, f"cli train --separator dpt --n-model {m} launched "
          f"{counts}, expected {want}")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    mix_dir = os.path.join(data, "cv", "mix")
    outs = {}
    for label, flags in (("tensor-parallel", ["--tensor-parallel", str(m)]),
                         ("unsharded", [])):
        sep_dir = os.path.join(work, f"sep_dpt_tp_{tag}_{label}")
        reset_dpt_all(dpt)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["separate", "--model-path", pkg, "--mix-dir",
                           mix_dir, "--out-dir", sep_dir, "--batch-size",
                           str(n_cv), "--device", "cuda", *flags])
        torch.cuda.synchronize()
        sep = dpt_partial_counts(dpt)
        want_sep = (dpt_partial_want(m, cfg.dpt_layers, 1, 0) if flags else
                    {**dict.fromkeys(sep, 0), "full": 4 * cfg.dpt_layers})
        check(rc == 0 and sep == want_sep, f"cli separate ({label}): rc {rc}"
              f", launches {sep}, expected {want_sep}")
        check_wavs(sep_dir, mix_dir)
        outs[label] = np.concatenate([
            read_wav(os.path.join(sep_dir, f))[0]
            for f in sorted(os.listdir(sep_dir)) if "_s" in f])
    err = rel_l2(torch.from_numpy(outs["tensor-parallel"]),
                 torch.from_numpy(outs["unsharded"]))
    print(f"cli separate --tensor-parallel {m} with the trained DPT package "
          f"(B={width}): "
          f"partial launches {dpt_partial_want(m, cfg.dpt_layers, 1, 0)} (1 "
          f"batch), wavs vs the unsharded cli separate rel_l2 {err:.3e} (bar "
          f"{TOL['bfloat16']:.0e}); train and separate phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(err <= TOL["bfloat16"], f"tensor-parallel DPT separate disagrees: "
          f"{err:.3e}")
    return counts

def kernel_bound(flops: float, nbytes: float, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of the operations' time (at the
    bf16 tensor-core peak, or ``peak``: PEAK_F32_FLOPS for FMA products in
    f32) and the memory time at an H100 SXM's published peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dpt_work(kind: str, args) -> tuple:
    """(flops, bytes) one DPT sublayer call needs on these inputs: every
    product of the Pallas kernel's cost estimate, at the heads' width Bq
    (B, or B / m for a partial kernel) and the FFN's hidden width; each
    input read once and the output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if hasattr(t, "numel")) + args[0].numel() * args[0].element_size()
    if kind == "ffn":
        M, K, B = args[0].shape
        return 2 * M * K * B * args[3].shape[1] * 2, nbytes
    M, n, S, B = args[0].shape
    Bq = args[3].shape[1] // 3
    mix = S * S if kind == "intra" else n * S
    return 2 * M * n * S * B * 4 * Bq + 4 * M * n * mix * Bq, nbytes


def dpt_bwd_work(kind: str, tensors, grads) -> tuple:
    """(flops, bytes) one DPT sublayer backward needs on these inputs
    (x, g, weights), counted product by product at 2 FLOP per
    multiply-add over its R rows; every input read once and every cotangent
    written once.

    FFN: pre = y W_up (recomputed), dh = g W_down^T, dy = dpre W_up^T,
    dW_up = y^T dpre and dW_down = h^T g, five products of 2 R B F.
    Attention: the QKV projection recomputed (3 B^2 per row), dA = g W_out^T
    and dW_out = a^T g (B^2 each), dW_qkv = y^T dqkv and dy = dqkv W_qkv^T
    (3 B^2 each), 11 products of 2 R B^2; and in the core six of 2 R keys B
    (s = q k^T and a = p v recomputed, dp = dA v^T, dv = p^T dA, dq = ds k,
    dk = ds^T q), with keys = S (intra) or n (inter) per query row. For a
    partial kernel B^2 is B Bq and the core's B is Bq, and F is F/m."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors, *grads) if t is not None)
    x = tensors[0]
    B = x.shape[-1]
    R = x.numel() // B
    if kind == "ffn":
        return 5 * 2 * R * B * tensors[4].shape[1], nbytes
    Bq = tensors[4].shape[1] // 3
    keys = x.shape[2] if kind == "intra" else x.shape[1]
    return 11 * 2 * R * B * Bq + 6 * 2 * R * keys * Bq, nbytes


def tcn_bwd_work(args, g, grads) -> tuple:
    """(flops, bytes) one block backward (kernel 2 or 3) needs on these
    inputs (x and the nine weights in ``args``, the cotangent g), counted
    product by product at 2 FLOP per multiply-add: x W_in recomputed,
    g W_out^T, hn2^T g, dh_pre W_in^T and x^T dh_pre, five of 2 M K B H;
    and the depthwise conv recomputed, its transpose and d_dw, three of
    2 M K H P. Every input read once and every cotangent written once."""
    x, dw = args[0], args[2]
    M, K, B = x.shape
    P, H = dw.shape
    nbytes = sum(t.numel() * t.element_size() for t in (*args, g, *grads))
    return 5 * 2 * M * K * B * H + 3 * 2 * M * K * H * P, nbytes


def phase_dpt_timings(torch, dpt, card: str):
    """Each DPT kernel, forward and backward, at [8, 25, 128, 256] bf16
    with the real mask, and its twin, in turns (twin, kernel, kernel,
    twin); the attention kernels (B7-B10) also at head widths 16 and 128,
    the kernel alone, and in f32 (their first designs) at head widths 16,
    32, 64 and 128, device time per call and the core's share; then the
    DPT forward at B=8 x 4 s bf16, kernel path and plain path in turns,
    and the DPT train step. Returns {kind: (ms, plain_ms,
    bound_ms, bound_by)} for the forwards and {kind: ...} for the
    backwards."""
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    rows, bwd_rows = {}, {}
    with torch.inference_mode():
        for kind in DPT_KINDS:
            fused, twin = dpt_fns(dpt, kind)
            args, kw, _ = dpt_inputs(torch, kind, torch.bfloat16, 25, 3199,
                                     seed=4000)
            t = time_turns(torch, {"plain": lambda: twin(*args, **kw),
                                   "kernel": lambda: fused(*args, **kw)}, 20)
            (ms, runs), (plain_ms, _) = t["kernel"], t["plain"]
            bound_ms, bound_by = kernel_bound(*dpt_work(kind, args))
            rows[kind] = (ms, plain_ms, bound_ms, bound_by)
            print(f"timing [{card}] dpt {kind} [8,25,128,256] bf16: kernel "
                  f"{ms:.4f} ms (runs {[round(r, 4) for r in runs]}),"
                  f" twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
        for kind in DPT_KINDS:
            fused, twin = dpt_bwd_fns(dpt, kind)
            x, g, w, kw, _ = dpt_bwd_inputs(torch, kind, torch.bfloat16, 25,
                                            3199, seed=4000)
            t = time_turns(torch, {"plain": lambda: twin(x, g, *w, **kw),
                                   "kernel": lambda: fused(x, g, *w, **kw)},
                           10)
            (ms, runs), (plain_ms, _) = t["kernel"], t["plain"]
            bound_ms, bound_by = kernel_bound(*dpt_bwd_work(
                kind, (x, g, *w), fused(x, g, *w, **kw)))
            bwd_rows[kind] = (ms, plain_ms, bound_ms, bound_by)
            print(f"timing [{card}] dpt {kind} backward [8,25,128,256] bf16: "
                  f"kernel {ms:.4f} ms (runs {[round(r, 4) for r in runs]}),"
                  f" twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
        # the attention kernels at the other head widths they take in
        # bf16: d = 16 (16 heads) and d = 128 (2), against d = 32 above
        for kind in ("inter", "intra"):
            for heads in (16, 2):
                args, kw, _ = dpt_inputs(torch, kind, torch.bfloat16, 25,
                                         3199, seed=4000, heads=heads)
                fused = dpt_fns(dpt, kind)[0]
                fwd_ms = time_ms(torch, lambda: fused(*args, **kw), 20)
                fused = dpt_bwd_fns(dpt, kind)[0]
                x, g, w, kw, _ = dpt_bwd_inputs(torch, kind, torch.bfloat16,
                                                25, 3199, seed=4000,
                                                heads=heads)
                bwd_ms = time_ms(torch, lambda: fused(x, g, *w, **kw), 10)
                print(f"timing [{card}] dpt {kind} [8,25,128,256] bf16 d="
                      f"{DPT_B // heads} ({heads} heads): forward {fwd_ms:.4f}"
                      f" ms (d=32 {rows[kind][0]:.4f}), backward "
                      f"{bwd_ms:.4f} ms (d=32 {bwd_rows[kind][0]:.4f})",
                      flush=True)

        # the f32 attention kernels (the first designs) at every head width
        # they take: d = 16, 32, 64 and 128 (16, 8, 4 and 2 heads)
        for kind in ("inter", "intra"):
            for heads in (16, 8, 4, 2):
                args, kw, _ = dpt_inputs(torch, kind, torch.float32, 25,
                                         3199, seed=4000, heads=heads)
                fused = dpt_fns(dpt, kind)[0]
                fwd_ms, fwd_k = device_ms(torch, lambda: fused(*args, **kw),
                                          10)
                fwd_ev = time_ms(torch, lambda: fused(*args, **kw), 10)
                fused = dpt_bwd_fns(dpt, kind)[0]
                x, g, w, kw, _ = dpt_bwd_inputs(torch, kind, torch.float32,
                                                25, 3199, seed=4000,
                                                heads=heads)
                bwd_ms, bwd_k = device_ms(
                    torch, lambda: fused(x, g, *w, **kw), 5)
                bwd_ev = time_ms(torch, lambda: fused(x, g, *w, **kw), 5)
                core = [sum(v for key, v in ks.items() if "core" in key)
                        for ks in (fwd_k, bwd_k)]
                print(f"timing [{card}] dpt {kind} [8,25,128,256] f32 d="
                      f"{DPT_B // heads} ({heads} heads): forward device "
                      f"{fwd_ms:.4f} ms (core {core[0]:.4f}; events "
                      f"{fwd_ev:.4f}), backward device {bwd_ms:.4f} ms "
                      f"(core {core[1]:.4f}; events {bwd_ev:.4f})",
                      flush=True)

        cfg = dpt_config()
        mix = torch.randn(8, SECONDS * SAMPLE_RATE, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(8))
        models = {name: ConvTasNet(cfg, use_pallas=flag, device="cuda").eval()
                  for name, flag in (("kernel", True), ("plain", False))}
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name].append(time_ms(torch, lambda: models[name](mix), 10))
    for name in ("kernel", "plain"):
        med = statistics.median(runs[name])
        print(f"timing [{card}] dpt forward B=8x{SECONDS}s bf16 {name} path: "
              f"{med:.3f} ms, {8 * SECONDS / (med / 1e3):.1f}x realtime "
              f"(runs {[round(r, 3) for r in runs[name]]})", flush=True)
    del models
    phase_train_timings(torch, cfg, card, "dpt", big_batch=False)
    return rows, bwd_rows


def device_ms(torch, fn, iters: int):
    """(ms, {kernel: ms}) of one call of fn on the device: its kernels'
    durations from torch.profiler summed per call, the host's time between
    launches left out, after two warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = {e.key: e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and "#" not in e.key}
    return sum(rows.values()), rows


def time_turns(torch, fns: dict, iters: int) -> dict:
    """{name: (median ms, runs)} over the turns of fns in order, then in
    reverse order (``time_ms`` each)."""
    runs = {name: [] for name in fns}
    for name in [*fns, *reversed(list(fns))]:
        runs[name].append(time_ms(torch, fns[name], iters))
    return {k: (statistics.median(v), v) for k, v in runs.items()}


def pair_work(args, out) -> tuple:
    """(flops, bytes) one block pair forward (B4) needs on these inputs:
    each block's two products and its depthwise conv at 2 FLOP per
    multiply-add; x and the 18 weights read once, the output written
    once."""
    x, pa, pb = args
    M, K, B = x.shape
    P, H = pa[1].shape
    nbytes = sum(t.numel() * t.element_size() for t in (x, *pa, *pb, out))
    return 2 * (2 * 2 * M * K * B * H + 2 * M * K * H * P), nbytes


def pair_bwd_work(args, g, grads) -> tuple:
    """(flops, bytes) one gLN pair backward (B5) needs on these inputs, as
    the Pallas kernel counts its work (``tcn_block_pair_bwd.py``'s cost
    estimate): 13 products of 2 M K B H (block 1's input product, x1's
    product and block 2's input product recomputed, five per block
    backward) and six depthwise passes of 2 M K H P; x, g and the 18
    weights read once, the 19 cotangents written once."""
    x, pa, pb = args
    M, K, B = x.shape
    P, H = pa[1].shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, g, *pa, *pb, *pair_grads(grads)))
    return 13 * 2 * M * K * B * H + 6 * 2 * M * K * H * P, nbytes


def phase_timings(torch, k, card: str):
    """The bf16 paper-config forward at B=8 and B=24 x 4 s and its train
    step, plain path and kernel path with pairs on and off, in turns, with
    peak memory; kernels 1 and 2 against their twins per dilation; the pair
    kernels B4 and B5 against two kernel-1 (kernel-2) calls and their twins
    per pair; each kernel's bound. Returns the per-kernel rows."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    tcn, bwd, pair, pair_bwd = (k[n] for n in ("tcn", "bwd", "pair",
                                               "pair_bwd"))
    cfg = ConvTasNetConfig(compute_dtype="bfloat16")
    models = {name: ConvTasNet(cfg, use_pallas=flag, device="cuda").eval()
              for name, flag in (("kernel", True), ("plain", False))}
    for M in (8, 24):
        mix = torch.randn(M, SECONDS * SAMPLE_RATE, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda")
        mem = {}

        def forward(model, pairs, name):
            def run():
                with pair_switch(pairs):
                    models[model](mix)
            return name, run

        fns = dict([forward("plain", True, "plain"),
                    forward("kernel", True, "kernel, pairs on"),
                    forward("kernel", False, "kernel, pairs off")])
        with torch.inference_mode():
            t = time_turns(torch, fns, 10 if M == 8 else 5)
            for name, fn in fns.items():
                torch.cuda.reset_peak_memory_stats()
                fn()
                mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        for name, (ms, runs) in t.items():
            print(f"timing [{card}] forward B={M}x{SECONDS}s bf16 {name}: "
                  f"{ms:.3f} ms, {M * SECONDS / (ms / 1e3):.1f}x realtime "
                  f"(runs {[round(r, 3) for r in runs]}), peak memory "
                  f"{mem[name]:.2f} GiB", flush=True)
    del models
    phase_train_timings(torch, cfg, card, "tcn", big_batch=True,
                        pair_states=(True, False))

    per_block = {}
    for d in DILATIONS:
        args = block_inputs(torch, torch.bfloat16, d)
        kw = dict(dilation=d, causal=False, norm_type="gLN")
        k_ms = time_ms(torch, lambda: tcn.fused_tcn_block(*args, **kw), 20)
        p_ms = time_ms(torch,
                       lambda: tcn.fused_tcn_block_reference(*args, **kw), 20)
        g = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
        kb_ms = time_ms(torch, lambda: bwd.fused_tcn_block_bwd(
            args[0], g, *args[1:], dilation=d, causal=False), 10)
        pb_ms = time_ms(torch, lambda: bwd.fused_tcn_block_bwd_reference(
            args[0], g, *args[1:], **kw), 10)
        per_block[d] = (k_ms, p_ms, kb_ms, pb_ms)
        print(f"timing [{card}] block [8,3199,256] H=512 gLN bf16 d={d}: "
              f"forward kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
              f"backward kernel {kb_ms:.4f} ms, twin {pb_ms:.4f} ms",
              flush=True)
    # the floors: the two products and the depthwise conv of the forward,
    # x and the weights read once and the output written once; the
    # backward's by tcn_bwd_work
    x, dw = args[0], args[2]
    M, K, B = x.shape
    P, H = dw.shape
    prod, conv = 2 * M * K * B * H, 2 * M * K * H * P
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    x_bytes = x.numel() * x.element_size()
    grads = bwd.fused_tcn_block_bwd(args[0], g, *args[1:], dilation=1,
                                    causal=False)
    bounds = (kernel_bound(2 * prod + conv, in_bytes + x_bytes),
              kernel_bound(*tcn_bwd_work(args, g, grads)))
    means = [statistics.mean(v[i] for v in per_block.values())
             for i in range(4)]
    for (ms, name), (bound_ms, by) in zip(((means[0], "forward"),
                                           (means[2], "backward")), bounds):
        print(f"bound [{card}] block {name} [8,3199,256] H=512 bf16: "
              f"{bound_ms:.4f} ms ({by}); kernel {ms:.4f} ms", flush=True)
    rows = {"b1": (means[0], means[1], bounds[0]),
            "b2": (means[2], means[3], bounds[1])}

    per_pair = []
    for d1, d2 in PAIRS:
        x, pa, pb = pair_inputs(torch, torch.bfloat16, d1)
        g = torch.randn(x.shape, device="cuda").to(torch.bfloat16)
        kw = dict(d1=d1, d2=d2, causal=False)

        def two_blocks():
            x1 = tcn.fused_tcn_block(x, *pa, dilation=d1, causal=False,
                                     norm_type="gLN")
            tcn.fused_tcn_block(x1, *pb, dilation=d2, causal=False,
                                norm_type="gLN")

        def two_bwds():
            bwd.fused_tcn_block_bwd(x, g, *pb, dilation=d2, causal=False)
            bwd.fused_tcn_block_bwd(x, g, *pa, dilation=d1, causal=False)

        with torch.inference_mode():
            fwd = time_turns(torch, {
                "pair": lambda: pair.fused_tcn_block_pair(
                    x, pa, pb, **kw, norm_type="gLN"),
                "two kernel-1 calls": two_blocks,
                "twin": lambda: pair.fused_tcn_block_pair_reference(
                    x, pa, pb, **kw, norm_type="gLN")}, 20)
        back = time_turns(torch, {
            "pair": lambda: pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb,
                                                              **kw),
            "two kernel-2 calls": two_bwds,
            "twin": lambda: pair_bwd.fused_tcn_block_pair_bwd_reference(
                x, g, pa, pb, **kw)}, 10)
        per_pair.append((fwd, back))
        print(f"timing [{card}] pair [8,3199,256] H=512 gLN bf16 "
              f"d=({d1},{d2}): forward B4 {fwd['pair'][0]:.4f} ms (runs "
              f"{[round(r, 4) for r in fwd['pair'][1]]}), two kernel-1 calls "
              f"{fwd['two kernel-1 calls'][0]:.4f} ms, twin "
              f"{fwd['twin'][0]:.4f} ms; backward B5 {back['pair'][0]:.4f} ms "
              f"(runs {[round(r, 4) for r in back['pair'][1]]}), two "
              f"kernel-2 calls {back['two kernel-2 calls'][0]:.4f} ms, twin "
              f"{back['twin'][0]:.4f} ms", flush=True)
    out = pair.fused_tcn_block_pair(x, pa, pb, **kw, norm_type="gLN")
    grads = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
    pair_bounds = (kernel_bound(*pair_work((x, pa, pb), out)),
                   kernel_bound(*pair_bwd_work((x, pa, pb), g, grads)))
    for i, (key, name, other) in enumerate((
            ("b4", "forward", "two kernel-1 calls"),
            ("b5", "backward", "two kernel-2 calls"))):
        ms = statistics.mean(p[i]["pair"][0] for p in per_pair)
        twin_ms = statistics.mean(p[i]["twin"][0] for p in per_pair)
        two_ms = statistics.mean(p[i][other][0] for p in per_pair)
        bound_ms, by = pair_bounds[i]
        print(f"bound [{card}] pair {name} [8,3199,256] H=512 bf16: "
              f"{bound_ms:.4f} ms ({by}); kernel {ms:.4f} ms, {other} "
              f"{two_ms:.4f} ms, twin {twin_ms:.4f} ms (means over the "
              f"pairs)", flush=True)
        rows[key] = (ms, twin_ms, pair_bounds[i])
    return rows


def phase_cln_timings(torch, bwd, card: str):
    """Kernel 3 against its twin, bf16, causal, [8, 3199, 256] H=512, at
    every dilation in turns (twin, kernel, kernel, twin), with its bound,
    and kernel 1's cLN forward beside it; f32 kernel 3 (its 3xTF32
    stages) at d = 1 the same way, with its bound at the 3xTF32 rate;
    then the causal cLN train step at B=8 x 4 s, bf16 and f32, kernel
    path against plain path, with each path's peak memory. Returns (mean
    kernel ms, mean twin ms, (bound_ms, bound_by)) of the bf16 kernel."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.ops.cuda import tcn_block as tcn

    kernel, plain, fwd = [], [], []
    for d in DILATIONS:
        args = block_inputs(torch, torch.bfloat16, d)
        g = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
        kw = dict(dilation=d, causal=True, norm_type="cLN")
        with torch.inference_mode():
            fwd.append(time_ms(torch, lambda: tcn.fused_tcn_block(*args, **kw),
                               20))
        t = time_turns(torch, {
            "plain": lambda: bwd.fused_tcn_block_bwd_reference(
                args[0], g, *args[1:], **kw),
            "kernel": lambda: bwd.fused_tcn_block_bwd(args[0], g, *args[1:],
                                                      **kw)}, 10)
        (k_ms, runs), (p_ms, _) = t["kernel"], t["plain"]
        kernel.append(k_ms)
        plain.append(p_ms)
        print(f"timing [{card}] block [8,3199,256] H=512 cLN causal bf16 "
              f"d={d}: forward kernel 1 {fwd[-1]:.4f} ms; backward kernel 3 "
              f"{k_ms:.4f} ms (runs {[round(r, 4) for r in runs]}), twin "
              f"{p_ms:.4f} ms", flush=True)
    grads = bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    bound = kernel_bound(*tcn_bwd_work(args, g, grads))
    means = (statistics.mean(kernel), statistics.mean(plain))
    print(f"bound [{card}] block backward cLN [8,3199,256] H=512 bf16: "
          f"{bound[0]:.4f} ms ({bound[1]}); kernel 3 {means[0]:.4f} ms, "
          f"twin {means[1]:.4f} ms; kernel 1 cLN forward "
          f"{statistics.mean(fwd):.4f} ms (means over d)", flush=True)
    args = block_inputs(torch, torch.float32, 1)
    g = torch.randn(args[0].shape, device="cuda")
    kw = dict(dilation=1, causal=True, norm_type="cLN")
    t = time_turns(torch, {
        "plain": lambda: bwd.fused_tcn_block_bwd_reference(
            args[0], g, *args[1:], **kw),
        "kernel": lambda: bwd.fused_tcn_block_bwd(args[0], g, *args[1:],
                                                  **kw)}, 10)
    grads = bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    bound32 = kernel_bound(*tcn_bwd_work(args, g, grads), peak=PEAK_3XTF32)
    print(f"timing [{card}] block [8,3199,256] H=512 cLN causal f32 d=1: "
          f"backward kernel 3 {t['kernel'][0]:.4f} ms (runs "
          f"{[round(r, 4) for r in t['kernel'][1]]}), twin "
          f"{t['plain'][0]:.4f} ms; bound at the 3xTF32 rate "
          f"{bound32[0]:.4f} ms ({bound32[1]})", flush=True)
    for dtype in ("bfloat16", "float32"):
        cfg = ConvTasNetConfig(compute_dtype=dtype, norm_type="cLN",
                               causal=True)
        phase_train_timings(torch, cfg, card, "tcn cLN causal",
                            big_batch=False)
    return means[0], means[1], bound


def phase_train_timings(torch, cfg, card: str, label: str,
                        big_batch: bool, pair_states=(True,)):
    """The train step (forward + backward + optimizer) at B=8 x 4 s in
    cfg's compute dtype, plain path and kernel path (for each pair switch
    state in ``pair_states``) in turns, with each path's peak memory; with
    ``big_batch`` also the kernel paths at B=24."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    step = ts.make_train_step()

    def step_ms(flag, pairs, M, iters):
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=flag)
        batch = train_batch(torch, M, 21)
        torch.cuda.reset_peak_memory_stats()
        with pair_switch(pairs):
            ms = time_ms(torch, lambda: step(state, batch), iters)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    paths = {"plain": (False, True)}
    for pairs in pair_states:
        name = "kernel" if len(pair_states) == 1 else \
            f"kernel, pairs {'on' if pairs else 'off'}"
        paths[name] = (True, pairs)
    runs = {name: [] for name in paths}
    mem = {}
    for name in [*paths, *reversed(list(paths))]:
        ms, mem[name] = step_ms(*paths[name], 8, 10)
        runs[name].append(ms)
    dt = "bf16" if cfg.compute_dtype == "bfloat16" else cfg.compute_dtype
    for name in paths:
        med = statistics.median(runs[name])
        print(f"timing [{card}] {label} train step B=8x{SECONDS}s {dt} "
              f"{name} path: {med:.3f} ms (runs "
              f"{[round(r, 3) for r in runs[name]]}), peak memory "
              f"{mem[name]:.2f} GiB", flush=True)
    if big_batch:
        for name, (flag, pairs) in paths.items():
            if not flag:
                continue
            ms24, mem24 = step_ms(True, pairs, 24, 5)
            print(f"timing [{card}] {label} train step B=24x{SECONDS}s {dt} "
                  f"{name} path: {ms24:.3f} ms, peak memory {mem24:.2f} GiB",
                  flush=True)


def tp_stage2_work(args, outs) -> tuple:
    """(flops, bytes) one TP stage 2 (B6) needs on these inputs: the
    depthwise conv and the partial out product at 2 FLOP per
    multiply-add; every input read once and z and the sums written once."""
    h, dw, w_out = args[0], args[2], args[3]
    M, K, Hs = h.shape
    P, B = dw.shape[0], w_out.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    return 2 * M * K * Hs * B + 2 * M * K * Hs * P, nbytes


def launch_shares(per: dict) -> str:
    """A call's device time per launch, each by its kernel's name without
    namespace or parameters."""
    return "; ".join(
        "{} {:.1f} us".format(key.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0], v * 1e3)
        for key, v in per.items())


def phase_tp_timings(torch, k, card: str):
    """B6 against its twin, bf16 and f32, [8, 3199, Hs] for Hs = 256 and
    128, in turns (twin, kernel, kernel, twin) at every dilation, with its
    bound (f32 at the 3xTF32 rate); f32 at d = 1 also in device time per
    call and per launch, with ``torch.matmul``'s device time at its
    product's shape in f32, TF32 off and on; B6 past 512 at [8, 3199, Hs],
    Hs = 576, 768 and 1024, d = 1, bf16 (its wide route) and f32: device
    time per call and per launch, with its bound, the twin's time and
    ``torch.matmul``'s device time at its product's shape ([8 x 3199, Hs]
    @ [Hs, 256], a yardstick no kernel calls); the paper-config forward at
    B=8 x 4 s over two and four shards against the unsharded kernel path
    (blocks singly), bf16 and f32, and the bf16 train step at B=8 x 4 s
    over two shards against the unsharded kernel step, in turns, with peak
    memory. Returns {Hs: (mean kernel ms, mean twin ms, (bound_ms,
    bound_by))} for Hs = 256 and 128 in bf16."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import (
        make_tcn_tp_train_step,
        tp_forward,
    )
    from convtasnet_tpu_torch.train import train_step as ts

    tp = k["tp"]
    rows = {}
    for Hs in (256, 128):
        kern, twin = [], []
        for d in DILATIONS:
            args = tp_stage2_inputs(torch, torch.bfloat16, Hs, d)
            kw = dict(dilation=d, causal=False)
            with torch.inference_mode():
                t = time_turns(torch, {
                    "twin": lambda: tp.tp_stage2_reference(*args, **kw),
                    "kernel": lambda: tp.fused_tp_stage2(*args, **kw)}, 20)
            kern.append(t["kernel"][0])
            twin.append(t["twin"][0])
            print(f"timing [{card}] tp stage 2 [8,3199,{Hs}] B=256 gLN bf16 "
                  f"d={d}: B6 {t['kernel'][0]:.4f} ms (runs "
                  f"{[round(r, 4) for r in t['kernel'][1]]}), twin "
                  f"{t['twin'][0]:.4f} ms", flush=True)
        with torch.inference_mode():
            outs = tp.fused_tp_stage2(*args, **kw)
        bound = kernel_bound(*tp_stage2_work(args, outs))
        rows[Hs] = (statistics.mean(kern), statistics.mean(twin), bound)
        print(f"bound [{card}] tp stage 2 [8,3199,{Hs}] B=256 bf16: "
              f"{bound[0]:.4f} ms ({bound[1]}); B6 {rows[Hs][0]:.4f} ms "
              f"({bound[0] / rows[Hs][0]:.1%} of the bound), twin "
              f"{rows[Hs][1]:.4f} ms (means over d)", flush=True)
    # f32, the default dtype: its one route on the 3xTF32 core
    for Hs in (256, 128):
        kern = []
        for d in DILATIONS:
            args = tp_stage2_inputs(torch, torch.float32, Hs, d)
            kw = dict(dilation=d, causal=False)
            with torch.inference_mode():
                t = time_turns(torch, {
                    "twin": lambda: tp.tp_stage2_reference(*args, **kw),
                    "kernel": lambda: tp.fused_tp_stage2(*args, **kw)}, 20)
            kern.append(t["kernel"][0])
            print(f"timing [{card}] tp stage 2 [8,3199,{Hs}] B=256 gLN f32 "
                  f"d={d}: B6 {t['kernel'][0]:.4f} ms by events (runs "
                  f"{[round(r, 4) for r in t['kernel'][1]]}), twin "
                  f"{t['twin'][0]:.4f} ms", flush=True)
        args = tp_stage2_inputs(torch, torch.float32, Hs, 1)
        kw = dict(dilation=1, causal=False)
        a = torch.randn(8 * 3199, Hs, device="cuda")
        with torch.inference_mode():
            ms, per = device_ms(
                torch, lambda: tp.fused_tp_stage2(*args, **kw), 20)
            outs = tp.fused_tp_stage2(*args, **kw)
            mm = {}
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                mm[tf32] = device_ms(
                    torch, lambda: torch.matmul(a, args[3]), 20)[0]
            torch.backends.cuda.matmul.allow_tf32 = False
        bound = kernel_bound(*tp_stage2_work(args, outs), PEAK_3XTF32)
        print(f"timing [{card}] tp stage 2 [8,3199,{Hs}] B=256 gLN f32 d=1: "
              f"B6 {ms:.4f} ms device ({launch_shares(per)}); bound "
              f"{bound[0]:.4f} ms ({bound[1]}, 3xTF32; {bound[0] / ms:.1%});"
              f" B6 by events {statistics.mean(kern):.4f} ms (mean over d);"
              f" torch.matmul f32 [{8 * 3199},{Hs}]x[{Hs},256] TF32 off "
              f"{mm[False]:.4f} ms, on {mm[True]:.4f} ms device", flush=True)
        del args, a, outs
    for Hs in TP_WIDE_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            args = tp_stage2_inputs(torch, dtype, Hs, 1, H=2 * Hs)
            kw = dict(dilation=1, causal=False)
            a = torch.randn(8 * 3199, Hs, device="cuda").to(dtype)
            b = torch.randn(Hs, 256, device="cuda").to(dtype)
            with torch.inference_mode():
                ms, per = device_ms(
                    torch, lambda: tp.fused_tp_stage2(*args, **kw), 20)
                twin_ms = time_ms(
                    torch, lambda: tp.tp_stage2_reference(*args, **kw), 10)
                mm_ms = device_ms(torch, lambda: torch.matmul(a, b), 20)[0]
                mm_ev = time_ms(torch, lambda: torch.matmul(a, b), 20)
                outs = tp.fused_tp_stage2(*args, **kw)
            bound = kernel_bound(*tp_stage2_work(args, outs),
                                 PEAK_BF16_FLOPS if name == "bfloat16"
                                 else PEAK_3XTF32)
            print(f"timing [{card}] tp stage 2 past 512 [8,3199,{Hs}] "
                  f"B=256 gLN {name} d=1: B6 {ms:.4f} ms device "
                  f"({launch_shares(per)})"
                  f"; bound {bound[0]:.4f} ms ({bound[1]}, "
                  f"{bound[0] / ms:.1%}); twin {twin_ms:.4f} ms; "
                  f"torch.matmul [{8 * 3199},{Hs}]x[{Hs},256] {mm_ms:.4f} "
                  f"ms device ({mm_ev:.4f} ms by events)", flush=True)
            del args, a, b, outs

    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda")
    for dt in ("bfloat16", "float32"):
        cfg = ConvTasNetConfig(compute_dtype=dt)
        model = ConvTasNet(cfg, use_pallas=True, device="cuda").eval()
        sd = model.state_dict()
        fns = {"unsharded kernel path": lambda: model(mix)}
        for m in TP_SHARDS:
            fns[f"TP m={m}"] = (lambda devs: lambda: tp_forward(
                cfg, sd, mix, devs))(shard_devices(m, "cuda"))
        mem = {}
        with torch.inference_mode(), pair_switch(False):
            t = time_turns(torch, fns, 10)
            for name, fn in fns.items():
                torch.cuda.reset_peak_memory_stats()
                fn()
                mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        for name, (ms, runs) in t.items():
            print(f"timing [{card}] forward B=8x{SECONDS}s {dt} {name}: "
                  f"{ms:.3f} ms, {8 * SECONDS / (ms / 1e3):.1f}x realtime "
                  f"(runs {[round(r, 3) for r in runs]}), peak memory "
                  f"{mem[name]:.2f} GiB", flush=True)
        del model, sd, fns
    cfg = ConvTasNetConfig(compute_dtype="bfloat16")

    steps = {"unsharded kernel step": ts.make_train_step(),
             "TP m=2 step": make_tcn_tp_train_step(
                 cfg, shard_devices(2, "cuda"))}
    runs = {name: [] for name in steps}
    mem = {}
    for name in [*steps, *reversed(list(steps))]:
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=True)
        batch = train_batch(torch, 8, 21)
        torch.cuda.reset_peak_memory_stats()
        with pair_switch(False):
            runs[name].append(time_ms(
                torch, lambda: steps[name](state, batch), 10))
        mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state
    for name, r in runs.items():
        print(f"timing [{card}] tcn train step B=8x{SECONDS}s bf16 {name}: "
              f"{statistics.median(r):.3f} ms (runs {[round(x, 3) for x in r]})"
              f", peak memory {mem[name]:.2f} GiB", flush=True)
    return rows


def phase_dpt_tp_timings(torch, dpt, card: str):
    """Each partial kernel (B7p-B12p), forward and backward, at [8, 25, 128,
    256] bf16 with the real mask on one shard of m = 2 and 4, and its twin,
    in turns (twin, kernel, kernel, twin), with its bound; then the DPT
    forward at B=8 x 4 s bf16 over two and four shards against the
    unsharded kernel path, and the DPT train step over two shards against
    the unsharded kernel step, in turns, with peak memory. Returns {m:
    {name: (ms, plain_ms, bound_ms, bound_by)}} for the partial kernels."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.dpt_tp import make_dpt_tp_train_step
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward
    from convtasnet_tpu_torch.train import train_step as ts

    rows = {}
    for m in DPT_TP_SHARDS:
        rows[m] = {}
        for kind in DPT_KINDS:
            kwp = dpt_partial_kw(kind, m)
            fused, twin = dpt_fns(dpt, kind)
            args, _, _ = dpt_inputs(torch, kind, torch.bfloat16, 25, 3199,
                                    seed=4000)
            sh = dpt_shard(torch, args, kind, m, 0)
            with torch.inference_mode():
                t = time_turns(torch, {"plain": lambda: twin(*sh, **kwp),
                                       "kernel": lambda: fused(*sh, **kwp)},
                               20)
            bound = kernel_bound(*dpt_work(kind, sh))
            rows[m][kind] = (t["kernel"][0], t["plain"][0], *bound)
            fused_b, twin_b = dpt_bwd_fns(dpt, kind)
            x, g, w, _, _ = dpt_bwd_inputs(torch, kind, torch.bfloat16, 25,
                                           3199, seed=4000)
            x, *w = dpt_shard(torch, (x, *w), kind, m, 0)
            tb = time_turns(torch, {
                "plain": lambda: twin_b(x, g, *w, **kwp),
                "kernel": lambda: fused_b(x, g, *w, **kwp)}, 10)
            bound_b = kernel_bound(*dpt_bwd_work(
                kind, (x, g, *w), fused_b(x, g, *w, **kwp)))
            rows[m][kind + "_bwd"] = (tb["kernel"][0], tb["plain"][0],
                                      *bound_b)
            for label, tt, bd in (("", t, bound), (" backward", tb, bound_b)):
                print(f"timing [{card}] dpt {kind}{label} partial, one of {m}"
                      f" shards [8,25,128,256] bf16: kernel "
                      f"{tt['kernel'][0]:.4f} ms (runs "
                      f"{[round(r, 4) for r in tt['kernel'][1]]}), twin "
                      f"{tt['plain'][0]:.4f} ms, bound {bd[0]:.4f} ms "
                      f"({bd[1]}, {bd[0] / tt['kernel'][0]:.1%} of it)",
                      flush=True)

    cfg = dpt_config()
    model = ConvTasNet(cfg, use_pallas=True, device="cuda").eval()
    sd = model.state_dict()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda")
    fns = {"unsharded kernel path": lambda: model(mix)}
    for m in DPT_TP_SHARDS:
        fns[f"TP m={m}"] = (lambda devs: lambda: tp_forward(
            cfg, sd, mix, devs))(shard_devices(m, "cuda"))
    mem = {}
    with torch.inference_mode():
        t = time_turns(torch, fns, 10)
        for name, fn in fns.items():
            torch.cuda.reset_peak_memory_stats()
            fn()
            mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, (ms, runs) in t.items():
        print(f"timing [{card}] dpt forward B=8x{SECONDS}s bf16 {name}: "
              f"{ms:.3f} ms, {8 * SECONDS / (ms / 1e3):.1f}x realtime (runs "
              f"{[round(r, 3) for r in runs]}), peak memory "
              f"{mem[name]:.2f} GiB", flush=True)
    del model

    steps = {"unsharded kernel step": ts.make_train_step(),
             "TP m=2 step": make_dpt_tp_train_step(
                 cfg, shard_devices(2, "cuda"))}
    runs = {name: [] for name in steps}
    mem = {}
    for name in [*steps, *reversed(list(steps))]:
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=True)
        batch = train_batch(torch, 8, 21)
        torch.cuda.reset_peak_memory_stats()
        runs[name].append(time_ms(torch, lambda: steps[name](state, batch),
                                  10))
        mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state
    for name, r in runs.items():
        print(f"timing [{card}] dpt train step B=8x{SECONDS}s bf16 {name}: "
              f"{statistics.median(r):.3f} ms (runs {[round(x, 3) for x in r]})"
              f", peak memory {mem[name]:.2f} GiB", flush=True)
    return rows

def torch_oracle():
    """``tests/torch_oracle.py`` (the independent torch model of the
    reference layout), loaded from its file: another package named
    ``tests`` may sit on the path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_oracle", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "torch_oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_package(torch, cfg, seed: int, path: str):
    """A reference-layout package of ``cfg`` at ``path``, as the reference
    repo's ``torch.save`` writes it (the hyperparameters, ``state_dict``,
    ``optim_dict`` and epoch), with random weights from
    ``tests/torch_oracle.make_state_dict``; returns the state dict."""
    sd = torch_oracle().make_state_dict(cfg, seed=seed)
    torch.save({"N": cfg.n_filters, "L": cfg.kernel_size,
                "B": cfg.bottleneck, "H": cfg.hidden, "P": cfg.conv_kernel,
                "X": cfg.num_blocks, "R": cfg.num_repeats,
                "C": cfg.num_speakers, "norm_type": cfg.norm_type,
                "causal": cfg.causal, "mask_nonlinear": cfg.mask_nonlinear,
                "state_dict": sd, "optim_dict": {}, "epoch": 0}, path)
    return sd


def read_estimates(out_dir: str, names) -> "list":
    import numpy as np

    from convtasnet_tpu_torch.data.audio_io import read_wav

    return np.stack([np.stack([read_wav(os.path.join(
        out_dir, n.replace(".wav", f"_s{c}.wav")))[0] for c in (1, 2)])
        for n in names])


def phase_reference_import(torch, k, work: str):
    """Reference PyTorch packages through the port's entry points on the
    card: a paper-config package (gLN) and a cLN causal one (k = 3 in the
    reference layout) at the paper widths with one repeat of 8 blocks,
    random weights from ``tests/torch_oracle.make_state_dict``. Each goes
    through ``cli import-torch``, then ``cli separate`` on the card of the
    four seeded 4 s mixtures of ``phase_main_path`` (one batch) in f32 and
    in bf16 (the imported package re-saved with ``compute_dtype``
    bfloat16), pairs on (B4, blocks / 2 per batch) and off (B1, one per
    block), with exact launch counts; the written wavs against
    ``torch_oracle.forward`` of the same mixtures on the card, written the
    same way, within 4e-2 (bf16) and 2e-3 (f32) by relative L2; then ``cli
    export-torch`` of the imported package gives back every tensor of the
    input bit for bit."""
    import dataclasses

    import numpy as np

    from convtasnet_tpu_torch import ConvTasNetConfig, cli
    from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
    from convtasnet_tpu_torch.train.checkpoint import (
        load_params_for_inference,
        save_inference_package,
    )
    oracle_forward = torch_oracle().forward
    mix_dir = os.path.join(work, "mix")
    names = sorted(f for f in os.listdir(mix_dir) if f.endswith(".wav"))
    mix = torch.from_numpy(np.stack([read_wav(os.path.join(mix_dir, n))[0]
                                     for n in names])).cuda()
    for label, cfg in (
            ("paper config gLN", ConvTasNetConfig()),
            ("cLN causal, 8 blocks", ConvTasNetConfig(
                norm_type="cLN", causal=True, num_repeats=1))):
        tag = "gln" if cfg.norm_type == "gLN" else "cln"
        n_blocks = cfg.num_blocks * cfg.num_repeats
        ref_path = os.path.join(work, f"reference_{tag}.pth.tar")
        ref = reference_package(torch, cfg, 21, ref_path)
        pkg = os.path.join(work, f"imported_{tag}.pt")
        check(cli.main(["import-torch", "--torch-path", ref_path,
                        "--out-path", pkg]) == 0, "cli import-torch failed")
        # the oracle's estimates, written and read back as separate does
        with torch.no_grad():
            want = oracle_forward({n: t.cuda() for n, t in ref.items()},
                                  cfg, mix).cpu().numpy()
        oracle_dir = os.path.join(work, f"oracle_{tag}")
        os.makedirs(oracle_dir)
        for i, n in enumerate(names):
            for c in (1, 2):
                write_wav(os.path.join(oracle_dir, n.replace(
                    ".wav", f"_s{c}.wav")), want[i, c - 1], SAMPLE_RATE)
        want = torch.from_numpy(read_estimates(oracle_dir, names))
        imported_cfg, sd = load_params_for_inference(pkg)
        for dtype in ("float32", "bfloat16"):
            path = pkg
            if dtype != imported_cfg.compute_dtype:
                path = os.path.join(work, f"imported_{tag}_{dtype}.pt")
                save_inference_package(path, dataclasses.replace(
                    imported_cfg, compute_dtype=dtype), sd)
            for pairs in (True, False):
                out_dir = os.path.join(
                    work, f"sep_ref_{tag}_{dtype}_{int(pairs)}")
                tcn_reset(k)
                with pair_switch(pairs):
                    rc = cli.main(["separate", "--model-path", path,
                                   "--mix-dir", mix_dir, "--out-dir",
                                   out_dir, "--batch-size", str(len(names))])
                torch.cuda.synchronize()
                counts = tcn_counts(k)
                want_counts = (tcn_want(b4=n_blocks // 2) if pairs
                               else tcn_want(b1=n_blocks))
                check(rc == 0 and counts == want_counts,
                      f"cli separate of the imported {label} package "
                      f"({dtype}, pairs {pairs}): rc {rc}, launches "
                      f"{counts}, expected {want_counts}")
                check_wavs(out_dir, mix_dir)
                err = rel_l2(torch.from_numpy(read_estimates(out_dir, names)),
                             want)
                print(f"imported reference package ({label}), cli separate "
                      f"{dtype}, pairs {'on' if pairs else 'off'}: launches "
                      f"{counts}, vs torch_oracle.forward rel_l2 {err:.3e} "
                      f"(bar {TOL[dtype]:.0e})", flush=True)
                check(err <= TOL[dtype], f"imported {label} ({dtype}) parts "
                      f"from the oracle: {err:.3e}")
        back = os.path.join(work, f"exported_{tag}.pth.tar")
        check(cli.main(["export-torch", "--ckpt-path", pkg, "--out-path",
                        back]) == 0, "cli export-torch failed")
        out = torch.load(back, map_location="cpu", weights_only=True)
        same = all(torch.equal(out["state_dict"][n], t)
                   for n, t in ref.items())
        print(f"cli export-torch of the imported {label} package: "
              f"{len(ref)} tensors, bit for bit {same}", flush=True)
        check(same, f"export-torch of the imported {label} package differs "
              "from its reference input")


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")


def phase_jax_checkpoint(torch, k, dpt, work: str, json_dir: str):
    """The JAX package's checkpoints on the card (the committed fixtures of
    ``scripts/make_jax_fixtures.py``: a small TCN and a small DPT after two
    JAX Adam steps, f32): each ``.ckpt`` loaded as ``separate`` loads it,
    its forward on the fixture's 1 s mixture against the JAX estimates
    stored beside it, the plain path within 5e-4 and the kernel path within
    2e-3 (max abs), and ``cli separate`` of the ``.ckpt`` through the
    kernels with exact launch counts; then ``cli train --continue-from``
    the TCN fixture, f32, ``--use-pallas 1``, pairs off, on the corpus of
    ``make_corpus`` (the fixture is at epoch 1, so ``--epochs 2`` runs one
    epoch of 4 steps at batch 8 and a cv pass): B1 and B2 launched per step
    and B1 per cv batch, and the checkpoint of that epoch holds the step
    count and the Adam steps continued from the fixture's 2."""
    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import write_wav
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_params_for_inference,
    )

    z = np.load(os.path.join(FIXTURES, "jax_fixtures.npz"))
    mix = torch.from_numpy(z["mixture"]).cuda()
    mix_dir = os.path.join(work, "jax_fixture_mix")
    os.makedirs(mix_dir)
    write_wav(os.path.join(mix_dir, "fixture.wav"), z["mixture"][0],
              SAMPLE_RATE)
    for name in ("tcn", "dpt"):
        path = os.path.join(FIXTURES, f"jax_{name}.ckpt")
        cfg, sd = load_params_for_inference(path, device="cuda")
        want = torch.from_numpy(z[f"{name}_est"]).cuda()
        n_blocks = cfg.num_blocks * cfg.num_repeats
        per_forward = ({"inter": cfg.dpt_layers, "intra": cfg.dpt_layers,
                        "ffn": 2 * cfg.dpt_layers} if name == "dpt"
                       else tcn_want(b1=n_blocks))
        for path_name, flag, bar in (("plain", False, 5e-4),
                                     ("kernel", None, 2e-3)):
            model = ConvTasNet(cfg, use_pallas=flag, device="cuda")
            model.load_state_dict(sd)
            model.eval()
            tcn_reset(k)
            reset_dpt_all(dpt)
            with pair_switch(False), torch.inference_mode():
                est = model(mix)
            torch.cuda.synchronize()
            counts = dpt_launches(dpt) if name == "dpt" else tcn_counts(k)
            expected = per_forward if flag is None else (
                dict.fromkeys(DPT_KINDS, 0) if name == "dpt" else tcn_want())
            err = (est - want).abs().max().item()
            print(f"JAX {name} checkpoint on the card, f32, {path_name} "
                  f"path: max abs {err:.3e} from the JAX estimates (bar "
                  f"{bar:.0e}), launches {counts}", flush=True)
            check(counts == expected, f"JAX {name} checkpoint, {path_name} "
                  f"path: launches {counts}, expected {expected}")
            check(err <= bar, f"JAX {name} checkpoint, {path_name} path: "
                  f"{err:.3e} from the JAX estimates")
        out_dir = os.path.join(work, f"jax_{name}_sep")
        tcn_reset(k)
        reset_dpt_all(dpt)
        with pair_switch(False):
            rc = cli.main(["separate", "--model-path", path, "--mix-dir",
                           mix_dir, "--out-dir", out_dir])
        torch.cuda.synchronize()
        counts = dpt_launches(dpt) if name == "dpt" else tcn_counts(k)
        check(rc == 0 and counts == per_forward,
              f"cli separate of the JAX {name} checkpoint: rc {rc}, "
              f"launches {counts}, expected {per_forward}")
        check_wavs(out_dir, mix_dir)
        print(f"cli separate of the JAX {name} checkpoint: launches "
              f"{counts}", flush=True)

    path = os.path.join(FIXTURES, "jax_tcn.ckpt")
    tree, meta = load_checkpoint(path)
    m = meta["model"]
    n_blocks, n_cv = m["num_blocks"] * m["num_repeats"], 2
    out = os.path.join(work, "exp_jax_resume")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    tcn_reset(k)
    with pair_switch(False):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--N", str(m["n_filters"]), "--L",
            str(m["kernel_size"]), "--B", str(m["bottleneck"]), "--H",
            str(m["hidden"]), "--X", str(m["num_blocks"]), "--R",
            str(m["num_repeats"]), "--use-pallas", "1", "--epochs", "2",
            "--batch-size", "8", "--print-freq", "1", "--enable-checkpoint",
            "1", "--continue-from", path])
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    counts = tcn_counts(k)
    check(rc == 0, f"cli train --continue-from the JAX checkpoint: rc {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    want = tcn_want(b1=n_blocks * (n_steps + n_cv), b2=n_blocks * n_steps)
    package, pmeta = load_checkpoint(os.path.join(
        out, "checkpoint_models", "epoch2.ckpt"))
    adam_steps = sorted({float(s["step"])
                         for s in package["optimizer"]["state"].values()})
    start = int(tree["step"])
    print(f"cli train --continue-from the JAX TCN checkpoint (step {start}, "
          f"epoch {meta['epoch']}), f32, --use-pallas 1: {n_steps} steps, "
          f"losses {[round(x, 4) for x in losses]}, launches {counts}; the "
          f"epoch-2 checkpoint at step {package['step']}, Adam steps "
          f"{adam_steps}", flush=True)
    check(n_steps == 4 and all(math.isfinite(x) for x in losses),
          f"resumed training: {n_steps} steps, losses {losses}")
    check(counts == want, f"resumed training launched {counts}, expected "
          f"{want}")
    check(package["step"] == start + n_steps
          and adam_steps == [float(start + n_steps)]
          and pmeta["epoch"] == 2, "the step count did not continue from "
          "the JAX checkpoint's")


WSJ0_SETS = {"tr": "si_tr_s", "cv": "si_dt_05", "tt": "si_et_05"}


def write_wsj0_tree(root: str, lists_dir: str, per_split) -> dict:
    """A small WSJ0-like disc tree: 16 kHz shorten-compressed NIST SPHERE
    ``.wv1`` files, written with the port's encoder from seeded signals (a
    modulated tone and noise per utterance, 1.2-2 s), in the layout
    ``disc/wsj0/<set>/<speaker>/<utt>.wv1``, and MERL-style
    ``mix_2_spk_<split>.txt`` lists pairing them (``per_split`` mixtures
    per split, two speakers each). Returns {decoded wav path relative to
    the prepared tree: int16 samples}."""
    import numpy as np

    from convtasnet_tpu_torch.data import shorten

    rng = np.random.default_rng(15)
    sr = 16000
    samples = {}
    os.makedirs(lists_dir)
    for split, set_ in WSJ0_SETS.items():
        rows = []
        for i in range(per_split[split]):
            entries = []
            for s in range(2):
                spk = f"{split}{i}{s}"
                utt = f"{spk}c020{s}"
                t = np.arange(int(rng.uniform(1.2, 2.0) * sr)) / sr
                x = (6000 * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
                     * (1 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 3) * t))
                     + rng.normal(0, 300, t.size)).astype(np.int16)
                payload = shorten.encode(x, ftype=shorten.TYPE_S16HL)
                header = ("NIST_1A\n   1024\n"
                          f"sample_count -i {len(x)}\n"
                          f"sample_rate -i {sr}\n"
                          "channel_count -i 1\n"
                          "sample_n_bytes -i 2\n"
                          "sample_byte_format -s2 10\n"
                          "sample_coding -s24 pcm,embedded-shorten-v2\n"
                          "end_head\n").encode()
                d = os.path.join(root, "disc11_1", "wsj0", set_, spk)
                os.makedirs(d)
                with open(os.path.join(d, utt + ".wv1"), "wb") as f:
                    f.write(header + b" " * (1024 - len(header)) + payload)
                samples[os.path.join("wsj0-wav", set_, spk, utt + ".wav")] = x
                entries.append(f"wsj0/{set_}/{spk}/{utt}.wv1")
            snr = round(float(rng.uniform(0.01, 2.5)), 4)
            rows.append(f"{entries[0]} {snr} {entries[1]} {-snr}\n")
        with open(os.path.join(lists_dir, f"mix_2_spk_{split}.txt"),
                  "w") as f:
            f.writelines(rows)
    return samples


def phase_corpus(torch, k, work: str):
    """Stage 0 to stage 4 from a raw corpus on the card: a WSJ0-like disc
    tree (``write_wsj0_tree``: 6 tr, 2 cv and 2 tt mixtures) through ``cli
    prepare --wsj0-root`` (every decoded source equal to the samples that
    were encoded), then ``cli recipe --stage 1 --stop-stage 4`` on its
    wav8k/min tree at the paper config, f32, ``--use-pallas 1``, pairs
    off, one epoch at batch 3 x 1 s: B1 32 times per step, per cv batch,
    per evaluated and per separated tt mixture (batch 1), B2 32 times per
    step; SI-SNRi finite and the separated wavs finite and of the
    mixtures' lengths."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav

    per_split = {"tr": 6, "cv": 2, "tt": 2}
    disc = os.path.join(work, "wsj0_discs")
    lists = os.path.join(work, "merl_lists")
    samples = write_wsj0_tree(disc, lists, per_split)
    prepared = os.path.join(work, "wsj0_2mix")
    check(cli.main(["prepare", "--wsj0-root", disc, "--lists-dir", lists,
                    "--out-dir", prepared]) == 0, "cli prepare failed")
    same = all(np.array_equal(read_wav(os.path.join(prepared, rel))[0]
                              * 32768.0, x.astype(np.float32))
               for rel, x in samples.items())
    tree = os.path.join(prepared, "wav8k", "min")
    counts_by_split = {s: len(os.listdir(os.path.join(tree, s, "mix")))
                       for s in per_split}
    print(f"cli prepare --wsj0-root: {len(samples)} shorten sources decoded, "
          f"each equal to its encoded samples: {same}; wav8k/min mixtures "
          f"{counts_by_split}", flush=True)
    check(same, "a decoded WSJ0 source differs from its encoded samples")
    check(counts_by_split == per_split, f"prepare wrote {counts_by_split}")

    work_dir = os.path.join(work, "recipe")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    tcn_reset(k)
    buf = io.StringIO()
    with pair_switch(False), contextlib.redirect_stdout(buf):
        rc = cli.main(["recipe", "--data-dir", tree, "--work-dir", work_dir,
                       "--stage", "1", "--stop-stage", "4", "--use-pallas",
                       "1", "--segment", "1", "--batch-size", "3",
                       "--epochs", "1", "--print-freq", "1"])
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    counts = tcn_counts(k)
    check(rc == 0, f"cli recipe returned {rc}")
    (exp,) = os.listdir(os.path.join(work_dir, "exp"))
    with open(os.path.join(work_dir, "exp", exp, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps, n_cv, n_tt = len(losses), per_split["cv"], per_split["tt"]
    res = json.loads([line for line in buf.getvalue().splitlines()
                      if line.startswith("{")][-1])
    want = tcn_want(b1=32 * (n_steps + n_cv + 2 * n_tt), b2=32 * n_steps)
    print(f"cli recipe stages 1-4 (paper config, f32, --use-pallas 1): "
          f"{n_steps} steps, losses {[round(x, 4) for x in losses]}, "
          f"evaluate {res}, launches {counts} (expected {want})", flush=True)
    check(n_steps >= 2 and all(math.isfinite(x) for x in losses),
          f"recipe training: {n_steps} steps, losses {losses}")
    check(math.isfinite(res["si_snri"]), f"recipe evaluate: {res}")
    check(counts == want, f"cli recipe launched {counts}, expected {want}")
    check_wavs(os.path.join(work_dir, "separate"), os.path.join(tree, "tt",
                                                                 "mix"))


def kernel_line(name, source, replaces, launches, max_abs, ms, plain_ms,
                bound):
    return {"name": name, "route": "cuda",
            "source": f"convtasnet_tpu_torch/csrc/{source}",
            "replaces": f"convtasnet_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            # no single PyTorch call computes the block or the sublayer
            "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from convtasnet_tpu_torch.ops.cuda import build
    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra

    k = tcn_modules()
    tcn, bwd = k["tcn"], k["bwd"]
    dpt = {"inter": dpt_attention, "intra": dpt_intra, "ffn": dpt_ffn}
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    compile_s = build.build()
    build.load_library()
    print(f"build: nvcc {compile_s:.2f} s, build+load "
          f"{time.perf_counter() - t0:.2f} s -> {build.library_path().name}",
          flush=True)

    max_abs = max(phase_kernel_vs_twin(torch, tcn),
                  phase_kernel_vs_twin(torch, tcn, "cLN", causal=True))
    max_abs_bwd = phase_bwd_vs_twin(torch, bwd)
    max_abs_cln = phase_bwd_vs_twin(torch, bwd, "cLN")
    max_abs_pair = phase_pair_vs_twin(torch, k)
    max_abs_pair_bwd = phase_pair_bwd_vs_twin(torch, k)
    max_abs_dpt = phase_dpt_kernels_vs_twin(torch, dpt)
    max_abs_dpt_bwd = phase_dpt_bwd_vs_twin(torch, dpt)
    max_abs_partial = phase_dpt_partial_vs_twin(torch, dpt)
    phase_intra_f32_wide_heads(torch, dpt)
    phase_intra_f32_long(torch, dpt)
    phase_ffn_bwd_tail_tiles(torch, dpt)
    max_abs_tp = phase_tp_stage2_vs_twin(torch, k)
    phase_auto_padded(torch, k, dpt)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_main_path(torch, k, work)
        data, json_dir = make_corpus(work)
        # the gLN paper config trains through kernels 1 and 2 by default
        # (CONVTASNET_PAIR_FUSION unset or 0), through the pairs (B4, B5)
        # with CONVTASNET_PAIR_FUSION=1: both, each with exact counts
        pairs_on = phase_train_path(torch, k, work, data, json_dir)
        pairs_off = phase_train_path(torch, k, work, data, json_dir,
                                     pairs=False)
        cln = phase_cln_train_path(torch, k, work, data, json_dir)
        # tensor parallelism (gLN, two and four shards on one card): the
        # forward, then cli train --n-model 2 and its package served
        # through cli separate --tensor-parallel 2, each with exact counts
        phase_tp_forward(torch, k)
        tp_train = phase_tp_train_path(torch, k, work, data, json_dir)
        # shards wider than 512 (B6's wide route): the paper config at
        # H = 2048 over two shards served, trained and separated
        phase_tp_wide(torch, k, work, data, json_dir)
        phase_dpt_forward(torch, dpt)
        dpt_launches_sep = phase_dpt_serving(torch, dpt, work)
        dpt_launches_bwd = phase_dpt_train_path(torch, dpt, work, data,
                                                json_dir)
        phase_dpt_chunk512_f32(torch, dpt, work, data, json_dir)
        # dual-path tensor parallelism (two and four shards on one card):
        # the forward, then cli train --separator dpt --n-model 2 and its
        # package served through cli separate --tensor-parallel 2, each
        # with exact counts of the partial kernels
        phase_dpt_tp_forward(torch, dpt)
        dpt_tp_train = phase_dpt_tp_train_path(torch, dpt, work, data,
                                               json_dir)
        # the DPT at --B 512, its kernels on their wide routes: each alone
        # against its twin, served and stepped against plain, cli train
        # --n-model 2 through B7p-B12p, and their device times
        phase_dpt_wide(torch, dpt, work, data, json_dir, card)
        # the DPT above 512 (--B 1024 and 576), on the routes beside the
        # resident tiles: each kernel alone against its twin and the
        # zero-column bits, served and stepped against plain, cli train /
        # separate / evaluate under auto, cli train --B 1024 --n-model 2,
        # and the device times at 1024
        phase_dpt_wider(torch, dpt, work, data, json_dir, card)
        # the DPT widths off 64, zero-padded with each LN over its own B:
        # each kernel alone against its twin, --B 96 served and stepped
        # against plain, cli train --B 192 --n-model 2 through B7p-B12p
        phase_dpt_padded(torch, dpt, work, data, json_dir)
        # the DPT attention at every head width: heads off the cores'
        # widths widened with zero columns and the real d's scale, above
        # 128 on the route beside the cores; each kernel alone against its
        # twin and the zero-column bits, --B 256 --dpt-heads 1 served and
        # stepped against plain, cli train / separate / evaluate under
        # auto, cli train --B 96 --dpt-heads 2 --n-model 2, device times
        phase_dpt_every_head_width(torch, dpt, work, data, json_dir, card)
        phase_streaming(torch, k, work, card)
        # the ways in: reference PyTorch packages, the JAX package's
        # checkpoints, and a raw shorten-compressed corpus through stage 0
        # and the staged recipe, each on the kernels with exact counts
        phase_reference_import(torch, k, work)
        phase_jax_checkpoint(torch, k, dpt, work, json_dir)
        phase_corpus(torch, k, work)
    phase_step_compare(torch, "tcn")
    phase_step_compare(torch, "tcn", "cLN")
    phase_step_compare(torch, "dpt")
    phase_tcn_taps(torch, k)
    # the f32 TCN blocks on their 3xTF32 stages: B1, B2 and B3 against
    # their twins and the f64 block, at 17 taps and padded widths too
    phase_tcn_f32_stages(torch, k)
    phase_dpt_chunk256_step(torch, dpt)
    phase_dpt_head_widths(torch, dpt)
    rows = phase_timings(torch, k, card)
    cln_ms, cln_plain_ms, cln_bound = phase_cln_timings(torch, bwd, card)
    dpt_times, dpt_bwd_times = phase_dpt_timings(torch, dpt, card)
    tp_rows = phase_tp_timings(torch, k, card)
    dpt_tp_rows = phase_dpt_tp_timings(torch, dpt, card)

    lines = [
        kernel_line("tcn_block", "tcn_block.cu", "tcn_block.py:92",
                    pairs_off["b1"], max_abs, *rows["b1"]),
        kernel_line("tcn_block_bwd", "tcn_block_bwd.cu",
                    "tcn_block_bwd.py:74", pairs_off["b2"], max_abs_bwd,
                    *rows["b2"]),
        kernel_line("tcn_block_bwd_cln", "tcn_block_bwd.cu",
                    "tcn_block_bwd.py:325", cln["b3"], max_abs_cln, cln_ms,
                    cln_plain_ms, cln_bound),
        kernel_line("tcn_block_pair", "tcn_block_pair.cu",
                    "tcn_block_pair.py:63", pairs_on["b4"], max_abs_pair,
                    *rows["b4"]),
        kernel_line("tcn_block_pair_bwd", "tcn_block_pair_bwd.cu",
                    "tcn_block_pair_bwd.py:63", pairs_on["b5"],
                    max_abs_pair_bwd, *rows["b5"]),
        # at two shards' width (Hs 256), as cli train --n-model 2 runs it
        kernel_line("tcn_block_tp", "tcn_block_tp.cu", "tcn_block_tp.py:148",
                    tp_train["b6"], max_abs_tp, *tp_rows[256])]
    for kind, source, replaces in (
            ("inter", "dpt_attention.cu", "dpt_attention.py:62"),
            ("intra", "dpt_intra.cu", "dpt_intra.py:53"),
            ("ffn", "dpt_ffn.cu", "dpt_ffn.py:41")):
        ms, plain_ms, bound_ms, bound_by = dpt_times[kind]
        lines.append(kernel_line(
            f"dpt_{kind}", source, replaces, dpt_launches_sep[kind],
            max_abs_dpt[kind], ms, plain_ms, (bound_ms, bound_by)))
    for kind, source, replaces in (
            ("inter", "dpt_attention_bwd.cu", "dpt_attention.py:271"),
            ("intra", "dpt_intra_bwd.cu", "dpt_intra.py:252"),
            ("ffn", "dpt_ffn_bwd.cu", "dpt_ffn.py:186")):
        ms, plain_ms, bound_ms, bound_by = dpt_bwd_times[kind]
        lines.append(kernel_line(
            f"dpt_{kind}_bwd", source, replaces, dpt_launches_bwd[kind],
            max_abs_dpt_bwd[kind], ms, plain_ms, (bound_ms, bound_by)))
    # the partial kernels on the TP path (cli train --n-model 2), timed at
    # two shards' widths, as that run launches them
    for name, source, replaces in (
            ("inter", "dpt_attention.cu", "dpt_attention.py:133"),
            ("intra", "dpt_intra.cu", "dpt_intra.py:121"),
            ("ffn", "dpt_ffn.cu", "dpt_ffn.py:78"),
            ("inter_bwd", "dpt_attention_bwd.cu", "dpt_attention.py:397"),
            ("intra_bwd", "dpt_intra_bwd.cu", "dpt_intra.py:368"),
            ("ffn_bwd", "dpt_ffn_bwd.cu", "dpt_ffn.py:228")):
        ms, plain_ms, bound_ms, bound_by = dpt_tp_rows[2][name]
        lines.append(kernel_line(
            f"dpt_{name}_partial", source, replaces,
            dpt_tp_train[name], max_abs_partial[name], ms, plain_ms,
            (bound_ms, bound_by)))
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
