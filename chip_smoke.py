#!/usr/bin/env python3
"""Drive the PyTorch port's TCN (gLN and causal cLN, blocks singly and as
block pairs, and gLN tensor-parallel) and dual-path (DPT, also
tensor-parallel) serving and training paths and its streaming separator
on one NVIDIA GPU, and check them.

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
   the exact (f32) cotangents: all ten within 4e-3 in f32, the eight
   besides the two PReLU slopes within 8e-2 in bf16; then the block pair:
   kernel B4 against its twin for each pair of dilations (1, 2) .. (64,
   128), gLN non-causal and cLN causal (and the other two at (4, 8)), at
   the JAX pair gate (6e-2 / 3e-3), and kernel B5 (the gLN pair backward)
   at kernel 2's gates on all 19 cotangents (the four PReLU slopes as one
   vector; one by one in f32 with every slope at 1, where no PReLU branch
   can flip), twice to the same bits; B4 against two chained kernel-1
   calls and B5 against chained kernels 1 + 2 + 2, to the bit in bf16 and
   f32 (a pair runs the singles' stages of its dtype and widths);
5. the three DPT sublayer kernels (inter, intra, FFN) against their twins
   at the DPT quality default's widths ([8, n, 128, 256], 8 heads, F=1024)
   with the real key mask, n = 1 (100 real frames), 25 (4 s) and 94
   (15 s), bf16 and f32, on the valid rows: 4e-2 in bf16, and in f32
   1e-5, tighter than the probe gate's 2e-3 because only the summation
   order differs there, and in f32 on rows of variance ~1e-3, where an LN
   eps off by 10x moves the output by ~4.5e-3; then their backward kernels
   (B8, B10, B12) at the same shapes, the intra one also at 256-frame
   chunks, with a random cotangent zero on the padded rows: every
   cotangent (dx on the valid rows) against the twin's exact f32
   cotangents, in f32 within 1e-5 (the kernels read <= 1.5e-6), in bf16
   within 4e-2 of the bf16 twin and no further from exact than
   max(4e-2, 1.25x the bf16 twin's own distance); the intra forward and
   backward in f32 with a head width of 64 at S = 256, their [S, d]
   tiles in the device workspace, against the exact twin within 1e-5;
   the partial kernels B7p-B12p (one shard's head group or hidden slice,
   the projection alone; ``partial=True``) at the quality default's shard
   widths, m = 2 (Bq 128, 4 heads, F/m 512) and m = 4 (Bq 64, 2 heads,
   256), at [8, 25, 128, 256], bf16 and f32, against their partial twins
   at the DPT bars, and the Megatron identity in f32 (the shards' partials
   summed plus the residual, plus b_down, against the full kernel, and
   the backwards' dx, dgamma and dbeta summed against the full backward)
   within 1e-5; then kernel B6 (stage 2 of a TCN block under tensor parallelism)
   against its twin at [8, 3199, Hs], Hs = 256 and 128 (two and four
   shards of H = 512), every dilation, gLN non-causal and causal, bf16 and
   f32: z and the gLN-2 sums within the forward bars, twice to the same
   bits;
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
   on the card;
9. the streaming separator on the card, f32, the paper widths with the
   causal cLN norm: two 4 s mixtures in 8 ms chunks rounded down to whole
   hops (7.5 ms), the stream plus its flush against the offline causal
   forward on the left-padded input, the plain path within STREAM_TOL and
   the kernel path within 2e-3 with pairs on (16 B4) and off (32 kernel
   1), the two the same bits; ``stream_demo`` at 8 ms, its wav against the
   stream within one PCM-16 step, and its latencies;
10. one train step's loss and gradients, kernel path against plain path,
   from the same init and batch (B=4 x 4 s, two batch seeds), for the
   TCN paper config, its causal cLN variant and the DPT quality default:
   in f32 the loss within 1e-5, the global gradient within 4e-3, every
   multi-element leaf correlated >= 0.9999 (a leaf with no correlation,
   such as an all-zero gradient, fails) and the PReLU slopes within 4e-3
   as one vector (the TCN's; the DPT has no scalar leaves); in bf16 the
   loss within 4e-2 and the kernel path's gradient no further from the
   f32 gradient than max(8e-2, 1.25x the plain bf16 path's); the gLN
   kernel path with pairs on and off (the same gradient bits in bf16 and
   f32) and the
   tensor-parallel step over two shards (64 B6 launches), each kernel's
   launches exact; the DPT's tensor-parallel step over two shards (the
   partial kernels 2 x (4, 4, 8) times forward and backward); and one
   bf16 DPT step with 256-frame chunks, the intra backward at S = 256;
11. timings (CUDA events, warm-ups excluded): the bf16 TCN forward at
   B=8 and B=24 x 4 s and the bf16 train step (forward + backward +
   optimizer) at B=8 x 4 s, kernel path with pairs on and off and plain
   path, with peak memory, for the paper config, and the kernel and plain
   steps of its causal cLN variant; the kernel paths' train step at B=24 x
   4 s; each TCN kernel against its twin per dilation (kernel 3 causal);
   B4 and B5 against two kernel-1 (kernel-2) calls and their twins per
   pair of dilations; each DPT
   kernel, forward and backward, against its twin at [8, 25, 128, 256];
   the DPT forward and the DPT train step at B=8 x 4 s, kernel path and
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
    evaluated in f32 on the same values: all ten within the f32 bar in
    f32, and in bf16 the eight besides the PReLU slopes within the bf16
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
                  + (f", {name} twin {fmt(errors(twin, exact))}"
                     if dtype == torch.bfloat16 else ""), flush=True)
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


def phase_step_compare(torch, separator: str = "tcn", norm: str = "gLN"):
    """Loss and gradients of one train step, kernel path vs plain path,
    from the same init and batch, for two batch seeds, for the paper
    config (``separator`` "tcn"), its causal cLN variant (``norm`` "cLN")
    or the DPT quality default ("dpt").

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
    against the plain bf16 path's own. The DPT model has no scalar leaves, and its
    kernel path launches each sublayer's backward kernel. The gLN model's
    kernel paths also include the tensor-parallel step over two shards on
    cuda:0 (``tp_loss_and_grads``: 64 B6 launches, no other TCN kernel),
    and the DPT's its tensor-parallel step over two shards (the partial
    kernels, 2 x (4, 4, 8) forward and backward launches, no full-mode
    one), held the same way. Every reading is printed before the phase
    fails."""
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
    for seed in (11, 12):
        batch = train_batch(torch, 4, seed)
        # the mixture with most samples moved by one or two f32 rounding
        # steps: how far the model itself carries such a difference
        mix = batch[0]
        nudged = (mix + mix * 2.0 ** -23 * torch.randn(
            mix.shape, generator=torch.Generator(device="cuda")
            .manual_seed(seed), device="cuda"), *batch[1:])
        for dtype in ("float32", "bfloat16"):
            cfg = ConvTasNetConfig(separator=separator, compute_dtype=dtype,
                                   norm_type=norm, causal=norm == "cLN")
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
    check(not failures, "train step, kernel vs plain: " + "; ".join(failures))


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
               S=DPT_S, x_scale=1.0, heads=DPT_HEADS):
    """Seeded operands of one DPT sublayer on the card at the quality
    default's widths (``heads`` heads), with the key mask of K real frames
    out of n*S, and x of standard deviation x_scale: (args, kwargs, valid
    [n, S])."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    B = DPT_B
    valid = torch.arange(n * S, device="cuda").reshape(n, S) < K
    x = rn(M, n, S, B, scale=x_scale).to(dtype)
    gamma, beta = 1.0 + 0.1 * rn(B), 0.1 * rn(B)
    if kind == "ffn":
        args = (x.reshape(M, n * S, B), gamma, beta,
                rn(B, DPT_F, scale=B ** -0.5).to(dtype), 0.1 * rn(DPT_F),
                rn(DPT_F, B, scale=DPT_F ** -0.5).to(dtype), 0.1 * rn(B))
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


# rows of standard deviation 0.0316 (variance ~1e-3): there an LN eps of
# 1e-5 put for 1e-6 moves the normalised rows by ~4.5e-3, where at unit
# variance it moves them by 4.5e-6, under the f32 bar
LOW_VAR_SCALE = 0.0316


def phase_dpt_kernels_vs_twin(torch, dpt):
    """Each DPT sublayer kernel against its plain twin at the quality
    default's widths ([8, n, 128, 256], 8 heads, F=1024) with the real key
    mask, for n = 1, 25 and 94, bf16 and f32, and in f32 at n = 25 with
    rows of variance ~1e-3 (which an LN eps off by 10x moves by ~4.5e-3):
    rel-L2 on the valid rows within 4e-2 / 1e-5. Every case is printed
    before the phase fails; returns the worst max_abs_err per kernel."""
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
                print(f"dpt {kind} kernel vs twin [8,{n},{DPT_S},{DPT_B}] "
                      f"K={K} {name} x std {x_scale}: rel_l2 {err:.3e} (bar "
                      f"{DPT_TOL[name]:.0e}) max_abs {abs_err:.3e}",
                      flush=True)
                if not finite or not err <= DPT_TOL[name]:
                    failures.append(f"{kind} n={n} {name} x std {x_scale}: "
                                    f"rel_l2 {err:.3e}"
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
                   S=DPT_S, heads=DPT_HEADS):
    """(x, g, the f32 weights, kwargs, valid [n, S]): ``dpt_inputs`` with
    the weights in f32, as the model keeps them, and a random cotangent
    that is zero on the padded rows, as the model delivers it."""
    args, kw, valid = dpt_inputs(torch, kind, dtype, n, K, seed, S=S,
                                 heads=heads)
    x = args[0]
    g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1))
    g = (g.reshape(8, -1, DPT_B) * valid.reshape(1, -1, 1)).reshape(x.shape)
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
    S = 256 (n = 13, 4 s), where its [S, S] tiles leave shared memory for
    the device workspace. Every case is printed before the phase fails;
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
        return t.reshape(t.shape[0], -1, DPT_B)[:, rows] if i == 0 else t

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


def phase_tp_stage2_vs_twin(torch, k):
    """Kernel B6 (TP stage 2) against its twin at [8, 3199, Hs], Hs = 256
    and 128 (two and four shards of H = 512), every dilation 1..128, gLN
    non-causal and causal, bf16 and f32: z and the gLN-2 sums within the
    forward bars (4e-2 / 2e-3), against the twin at B6's own rounding
    points within TP_ORDER_TOL, finite, and two calls the same bits.
    Every case is printed before the phase fails; returns the worst
    max_abs_err of z."""
    tp = k["tp"]
    worst = 0.0
    failures = []
    t0 = time.perf_counter()
    for Hs in (256, 128):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            for causal in (False, True):
                for d in DILATIONS:
                    args = tp_stage2_inputs(torch, dtype, Hs, d)
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
    print(f"tp stage 2 (B6) vs twin: 64 cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(not failures, "TP stage-2 kernel disagrees with its twin: "
          + "; ".join(failures))
    return worst


def phase_tp_forward(torch, k):
    """``tp_forward`` of the paper config (random weights from seed 0) at
    B=8 x 4 s over two and four shards, all on cuda:0, bf16 and f32: 32 m
    launches of B6 and none of any other TCN kernel, finite, and within
    the forward bars of the unsharded kernel path (blocks singly) and of
    the plain path."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    t0 = time.perf_counter()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    for dtype in ("bfloat16", "float32"):
        cfg = ConvTasNetConfig(compute_dtype=dtype)
        n_blocks = cfg.num_repeats * cfg.num_blocks
        kernel = ConvTasNet(cfg, use_pallas=True, device="cuda").eval()
        plain = ConvTasNet(cfg, use_pallas=False, device="cuda").eval()
        with torch.inference_mode(), pair_switch(False):
            want_k, want_p = kernel(mix), plain(mix)
            sd = kernel.state_dict()
            for m in TP_SHARDS:
                devices = shard_devices(m, "cuda")
                tcn_reset(k)
                got = tp_forward(cfg, sd, mix, devices)
                torch.cuda.synchronize()
                counts = tcn_counts(k)
                ek, ep = rel_l2(got, want_k), rel_l2(got, want_p)
                print(f"tp_forward paper config B=8x{SECONDS}s {dtype} over "
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


def phase_tp_train_path(torch, k, work: str, data: str, json_dir: str):
    """``cli train --n-model 2 --use-pallas 1`` at the paper config, bf16,
    on the corpus of ``make_corpus`` (one epoch of 4 steps at batch 8 and
    a cv pass): every loss finite, B6 launched 64 times per step and per cv
    batch and no other TCN kernel; then its package served through ``cli
    separate --tensor-parallel 2`` (64 B6 per batch) against the unsharded
    ``cli separate`` (32 kernel-1 launches, pairs off): finite wavs within
    the bf16 forward bar. Returns the launch counts of the train run."""
    import contextlib
    import io

    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav

    n_blocks, n_cv, m = 32, 2, 2
    out = os.path.join(work, "exp_tp")
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
            "--batch-size", "8", "--print-freq", "1"])
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
    print(f"cli train --n-model {m} (paper config, bf16, --use-pallas 1; "
          f"{placement}): {n_steps} steps, losses "
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
        sep_dir = os.path.join(work, f"sep_tp_{label}")
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
    print(f"cli separate --tensor-parallel {m} with the trained package: "
          f"launches {tcn_want(b6=n_blocks * m)} (1 batch), wavs vs the "
          f"unsharded cli separate rel_l2 {err:.3e} (bar "
          f"{TOL['bfloat16']:.0e}); train and separate phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(err <= TOL["bfloat16"], f"tensor-parallel separate disagrees: "
          f"{err:.3e}")
    return counts


def phase_dpt_chunk256_step(torch, dpt):
    """One bf16 train step (loss and gradients) of the DPT quality default
    with 256-frame chunks (``--dpt-chunk 256``), B=4 x 4 s, kernel path
    against plain path from the same init and batch, as
    ``phase_step_compare`` holds bf16: the loss within 4e-2 and the kernel
    path's gradient no further from the plain f32 gradient than max(8e-2,
    1.25x the plain bf16 path's); the intra backward kernel runs at
    S = 256, once per layer."""
    import dataclasses

    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.train import train_step as ts

    cfg = dataclasses.replace(dpt_config(), dpt_chunk=256)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    batch = train_batch(torch, 4, 13)
    res = {}
    intra_bwd = dpt_bwd_fns(dpt, "intra")[0]
    for path, flag, dtype in (("kernel", True, "bfloat16"),
                              ("plain", False, "bfloat16"),
                              ("plain f32", False, "float32")):
        state = ts.create_train_state(
            dataclasses.replace(cfg, compute_dtype=dtype), SolverConfig(),
            device="cuda", use_pallas=flag, state_dict=sd)
        intra_bwd.launches = 0
        loss = float(ts._loss_and_grads(state.model, batch, 0))
        torch.cuda.synchronize()
        check(intra_bwd.launches == (cfg.dpt_layers if flag else 0),
              f"dpt chunk 256 {path}: {intra_bwd.launches} intra backward "
              f"launches")
        res[path] = (loss, torch.cat([p.grad.detach().float().reshape(-1)
                                      for p in state.model.parameters()]))
        del state
    (lk, gk), (lp, gp), (_, gf) = res["kernel"], res["plain"], res["plain f32"]
    loss_rel = abs(lk - lp) / abs(lp)
    k_f32, p_f32 = rel_l2(gk, gf), rel_l2(gp, gf)
    bar = max(BWD_TOL["bfloat16"], 1.25 * p_f32)
    print(f"train step dpt --dpt-chunk 256 bf16 B=4x{SECONDS}s kernel vs "
          f"plain: loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}); from the "
          f"f32 gradient: kernel path {k_f32:.3e}, plain path {p_f32:.3e} "
          f"(bar {bar:.3e})", flush=True)
    check(torch.isfinite(gk).all().item(), "dpt chunk 256: non-finite "
          "gradient")
    check(loss_rel <= 4e-2 and k_f32 <= bar,
          f"dpt chunk 256 step: loss {loss_rel:.3e}, gradient {k_f32:.3e}")


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
    valid rows; backward as ``compare_cotangents``, the FFN's db_down all
    zero); then the Megatron identity in f32: the m shards' partials
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
                print(f"dpt {kind} partial kernel vs twin, shard {m - 1} of "
                      f"{m} [8,25,{DPT_S},{DPT_B}] {name}: rel_l2 {err:.3e} "
                      f"(bar {DPT_TOL[name]:.0e})", flush=True)
                if not finite or not err <= DPT_TOL[name]:
                    failures.append(f"{kind} m={m} {name}: {err:.3e}")
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


def phase_dpt_tp_train_path(torch, dpt, work: str, data: str, json_dir: str):
    """``cli train --separator dpt --n-model 2 --use-pallas 1`` at the DPT
    quality default, bf16, on the corpus of ``make_corpus`` (one epoch of 4
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

    cfg = dpt_config()
    n_cv, m = 2, 2
    out = os.path.join(work, "exp_dpt_tp")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    buf = io.StringIO()
    reset_dpt_all(dpt)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "train", "--train-dir", os.path.join(json_dir, "tr"),
            "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder",
            out, "--device", "cuda", "--separator", "dpt", "--compute-dtype",
            "bfloat16", "--use-pallas", "1", "--n-model", str(m), "--epochs",
            "1", "--batch-size", "8", "--print-freq", "1"])
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
    print(f"cli train --separator dpt --n-model {m} (quality default, bf16, "
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
        sep_dir = os.path.join(work, f"sep_dpt_tp_{label}")
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
    print(f"cli separate --tensor-parallel {m} with the trained DPT package: "
          f"partial launches {dpt_partial_want(m, cfg.dpt_layers, 1, 0)} (1 "
          f"batch), wavs vs the unsharded cli separate rel_l2 {err:.3e} (bar "
          f"{TOL['bfloat16']:.0e}); train and separate phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(err <= TOL["bfloat16"], f"tensor-parallel DPT separate disagrees: "
          f"{err:.3e}")
    return counts

def kernel_bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the bf16 tensor-core time and the
    memory time at an H100 SXM's published peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
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
    twin); then the DPT forward at B=8 x 4 s bf16, kernel path and plain
    path in turns, and the DPT train step. Returns {kind: (ms, plain_ms,
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
    and kernel 1's cLN forward beside it; then the bf16 causal cLN train
    step at B=8 x 4 s, kernel path against plain path, with each path's
    peak memory. Returns (mean kernel ms, mean twin ms, (bound_ms,
    bound_by))."""
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
    cfg = ConvTasNetConfig(compute_dtype="bfloat16", norm_type="cLN",
                           causal=True)
    phase_train_timings(torch, cfg, card, "tcn cLN causal", big_batch=False)
    return means[0], means[1], bound


def phase_train_timings(torch, cfg, card: str, label: str,
                        big_batch: bool, pair_states=(True,)):
    """The bf16 train step (forward + backward + optimizer) at B=8 x 4 s,
    plain path and kernel path (for each pair switch state in
    ``pair_states``) in turns, with each path's peak memory; with
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
    for name in paths:
        med = statistics.median(runs[name])
        print(f"timing [{card}] {label} train step B=8x{SECONDS}s bf16 "
              f"{name} path: {med:.3f} ms (runs "
              f"{[round(r, 3) for r in runs[name]]}), peak memory "
              f"{mem[name]:.2f} GiB", flush=True)
    if big_batch:
        for name, (flag, pairs) in paths.items():
            if not flag:
                continue
            ms24, mem24 = step_ms(True, pairs, 24, 5)
            print(f"timing [{card}] {label} train step B=24x{SECONDS}s bf16 "
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


def phase_tp_timings(torch, k, card: str):
    """B6 against its twin, bf16, [8, 3199, Hs] for Hs = 256 and 128, in
    turns (twin, kernel, kernel, twin) at every dilation, with its bound;
    the bf16 paper-config forward at B=8 x 4 s over two and four shards
    against the unsharded kernel path (blocks singly), and the bf16 train
    step at B=8 x 4 s over two shards against the unsharded kernel step,
    in turns, with peak memory. Returns {Hs: (mean kernel ms, mean twin ms,
    (bound_ms, bound_by))}."""
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

    cfg = ConvTasNetConfig(compute_dtype="bfloat16")
    model = ConvTasNet(cfg, use_pallas=True, device="cuda").eval()
    sd = model.state_dict()
    mix = torch.randn(8, SECONDS * SAMPLE_RATE, generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda")
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
        print(f"timing [{card}] forward B=8x{SECONDS}s bf16 {name}: "
              f"{ms:.3f} ms, {8 * SECONDS / (ms / 1e3):.1f}x realtime (runs "
              f"{[round(r, 3) for r in runs]}), peak memory "
              f"{mem[name]:.2f} GiB", flush=True)
    del model

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
    max_abs_tp = phase_tp_stage2_vs_twin(torch, k)
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
        phase_dpt_forward(torch, dpt)
        dpt_launches_sep = phase_dpt_serving(torch, dpt, work)
        dpt_launches_bwd = phase_dpt_train_path(torch, dpt, work, data,
                                                json_dir)
        # dual-path tensor parallelism (two and four shards on one card):
        # the forward, then cli train --separator dpt --n-model 2 and its
        # package served through cli separate --tensor-parallel 2, each
        # with exact counts of the partial kernels
        phase_dpt_tp_forward(torch, dpt)
        dpt_tp_train = phase_dpt_tp_train_path(torch, dpt, work, data,
                                               json_dir)
        phase_streaming(torch, k, work, card)
    phase_step_compare(torch, "tcn")
    phase_step_compare(torch, "tcn", "cLN")
    phase_step_compare(torch, "dpt")
    phase_dpt_chunk256_step(torch, dpt)
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
