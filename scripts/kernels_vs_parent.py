#!/usr/bin/env python3
"""The port's kernels in this tree against those of another checkout, on
one NVIDIA GPU.

    python3 scripts/kernels_vs_parent.py --other DIR [--time] \\
        [--out FILE]

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive HEAD convtasnet_tpu_torch``).
Each tree's package runs in a subprocess of its own, builds its kernels
from its own sources and writes its outputs at shapes both trees take:

- bit for bit (``torch.equal``): the DPT sublayer kernels in full mode
  (B7-B12) at the quality default's widths ([8, 25, 128, 256], 8 heads,
  F=1024, the real key mask), bf16 and f32, the intra kernels also at the
  chunk lengths whose tiles sit in shared memory or spill to the device
  workspace, the TCN TP stage 2 (B6) at [8, 3199, Hs], Hs = 256 and 128,
  and the TCN block forward (B1, gLN and cLN causal), the gLN block
  backward (B2) and the cLN one (B3) at the paper shape [8, 3199, 256],
  H=512, bf16 and f32, d = 1, 16, 128. A change to the kernels' shared
  pieces must leave these bits as they were;
- by distance: the block pair forward (B4, gLN and cLN causal) and the gLN
  pair backward (B5) at the paper shape, bf16 and f32, (d1, d2) = (1, 2),
  (16, 32), (64, 128): the relative L2 between the two trees and each
  tree's own distance from its plain twin (B5's evaluated in exact f32),
  held at the pair bars.

Every TCN output also prints each tree's distance from its twin.

``--time`` then times both trees in turns (other, this, this, other; one
subprocess each, on the same card), in bf16 at the paper shape unless
named: B1 (gLN and cLN causal), B2 and B3 per dilation 1..128; B4 (gLN
and cLN causal) and B5 per pair of dilations (1, 2) .. (64, 128), and
beside each in the same turn two chained B1 calls and B1 + 2 x B2; the
gLN B4 and B5 beside the same also in f32 ("f32") and in bf16 at H=192
("H=192"), which run the first design's launches; the paper-config
forward and gLN train step at B=8 and B=24 x 4 s with pairs on and off,
with the peak device memory of each, and the cLN causal step at B=8;
and ``torch.matmul`` at each of the blocks' products' shapes (a yardstick
of the product core alone; no kernel calls it). ``--out`` writes every
number as JSON. Exits nonzero if a bit-for-bit output differs or a kernel
is further from its twin than its bar.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kind, dtype, S, heads at B = 256, run the forward, run the backward):
# every sublayer at the quality default, and the intra kernels at shapes
# whose tiles fitted in shared memory before the workspace spill of the
# [S, d] tiles, or spilled only the backward's [S, S] tiles
CASES = [(kind, dtype, 128, 8, True, True)
         for kind in ("inter", "intra", "ffn")
         for dtype in ("bfloat16", "float32")]
CASES += [("intra", "bfloat16", 256, 4, True, True),
          ("intra", "float32", 176, 4, True, True),
          ("intra", "float32", 208, 4, False, True)]
B6_CASES = [(dtype, hs, d) for dtype in ("bfloat16", "float32")
            for hs in (256, 128) for d in (1, 128)]
# (kernel, norm, causal): B1 gLN and cLN causal, B2 gLN, B3 cLN causal
TCN_KERNELS = [("b1", "gLN", False), ("b1", "cLN", True),
               ("b2", "gLN", False), ("b3", "cLN", True)]
TCN_CASES = [(kern, norm, causal, dtype, d)
             for kern, norm, causal in TCN_KERNELS
             for dtype in ("bfloat16", "float32") for d in (1, 16, 128)]
# (kernel, norm, causal): B4 gLN and cLN causal, B5 gLN
PAIR_KERNELS = [("b4", "gLN", False), ("b4", "cLN", True),
                ("b5", "gLN", False)]
PAIR_CASES = [(kern, norm, causal, dtype, d1)
              for kern, norm, causal in PAIR_KERNELS
              for dtype in ("bfloat16", "float32") for d1 in (1, 16, 64)]
# the twin bars: the forward's and the backward's (the JAX probe and train
# gates), the pair forward at 1.5x the block's (the JAX pair gate)
TCN_TOL = {("b1", "bfloat16"): 4e-2, ("b1", "float32"): 2e-3,
           ("b4", "bfloat16"): 6e-2, ("b4", "float32"): 3e-3,
           ("bwd", "bfloat16"): 8e-2, ("bwd", "float32"): 4e-3}
# outputs held bit for bit against the other tree; the rest by distance
BIT_KEYS = ("dpt ", "b6 ", "b1 ", "b2 ", "b3 ")
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


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _tcn_tol(key: str) -> float:
    kern, dtype = key.split()[:2]
    return TCN_TOL[kern if kern in ("b1", "b4") else "bwd", dtype]


def compare(mine: dict, other: dict):
    """Lines to print and the keys at fault: the outputs under
    ``BIT_KEYS`` (DPT, B6, B1-B3) must equal the other tree's bit for bit;
    each ``b4``/``b5`` output reports its relative L2 to the other tree's,
    and is at fault when this tree's distance from its twin (the ``twin ``
    entry) exceeds its bar. Every output with a twin entry prints both
    trees' distances from their twins."""
    lines, bad = [], []
    for key in sorted(k for k in other if not k.startswith("twin ")):
        if key not in mine:
            lines.append(f"{key}: missing in this tree")
            bad.append(key)
            continue
        twin = ""
        if f"twin {key}" in mine and f"twin {key}" in other:
            mt, ot = mine[f"twin {key}"], other[f"twin {key}"]
            twin = (f"; from the twin this tree {mt:.3e}, other {ot:.3e} "
                    f"(bar {_tcn_tol(key):.0e})")
        if key.startswith(BIT_KEYS):
            same = mine[key].shape == other[key].shape and bool(
                (mine[key] == other[key]).all())
            lines.append(f"{key}: {'same bits' if same else 'DIFFERENT'}"
                         + twin)
            if not same:
                bad.append(key)
            continue
        lines.append(f"{key}: trees apart rel_l2 "
                     f"{rel_l2(mine[key], other[key]):.3e}" + twin)
        if not mine[f"twin {key}"] <= _tcn_tol(key):
            bad.append(key)
    return lines, bad


def summarize(turns: list) -> list:
    """Lines for the timed turns [(tree, {metric: ms}), ...] in the order
    run: each metric's times per tree in turn order, the means and the
    ratio this / other."""
    lines = []
    metrics = [m for m in turns[0][1]]
    for metric in metrics:
        per = {}
        for tree, res in turns:
            if metric in res:
                per.setdefault(tree, []).append(res[metric])
        if set(per) != {"this", "other"}:
            continue
        unit = "GiB" if metric.startswith("peak ") else "ms"
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
    for metric, at in series:
        for tree in ("other", "this"):
            vals = [res[f"{metric} {a}"] for t, res in turns if t == tree
                    for a in at if f"{metric} {a}" in res]
            if vals:
                lines.append(f"{metric} mean over "
                             f"{'pairs' if '(' in at[0] else 'd'}, {tree}: "
                             f"{sum(vals) / len(vals):.4f} ms")
    return lines


def _block_inputs(torch, dtype, seed: int, norm: str, H=H):
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for kind, dtype, S, heads, fwd, bwd in CASES:
        g = torch.Generator(device="cuda").manual_seed(S + heads)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        Bd, F, n = 256, 1024, 3199 // S + 1
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
        fused, fused_bwd = fns[kind]
        if fwd:
            with torch.inference_mode():
                out[f"{key} forward"] = fused(x, *w, **kw).cpu()
        if bwd:
            gr = (rn(M, n * S, Bd) * valid.reshape(1, -1, 1)).reshape(
                x.shape).to(dt)
            for i, t in enumerate(fused_bwd(x, gr, *w, **kw)):
                out[f"{key} backward {i}"] = t.cpu()
        torch.cuda.synchronize()
    for dtype, hs, d in B6_CASES:
        g = torch.Generator(device="cuda").manual_seed(hs + d)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        h = torch.nn.functional.leaky_relu(rn(M, K, hs), 0.25).to(
            getattr(torch, dtype))
        stats1 = torch.stack([0.1 * rn(M), 1.0 + 0.1 * rn(M)], dim=-1)
        with torch.inference_mode():
            z, sums = tcn_block_tp.fused_tp_stage2(
                h, stats1, rn(P, hs) * 0.1, rn(hs, B) * hs ** -0.5,
                torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(hs),
                0.1 * rn(hs), 1.0 + 0.1 * rn(hs), dilation=d, causal=False)
        out[f"b6 {dtype} Hs={hs} d={d} z"] = z.cpu()
        out[f"b6 {dtype} Hs={hs} d={d} sums"] = sums.cpu()
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


def time_tree(path: str) -> None:
    import torch

    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import PAIR_ENV, ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import tcn_block, tcn_block_bwd
    from convtasnet_tpu_torch.train import train_step as ts

    os.environ[PAIR_ENV] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
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
    # f32, and bf16 at a width the Hopper stages do not take: the first
    # design's launches
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
    for name, (r, k, n) in PRODUCTS.items():
        a = torch.randn(r, k, device="cuda").bfloat16()
        b = torch.randn(k, n, device="cuda").bfloat16()
        res[f"torch.matmul {name} [{r},{k}]x[{k},{n}]"] = _ms(
            torch, lambda: torch.matmul(a, b), 20)
    torch.save(res, path)


def _run(mode: str, root: str, path: str, cwd: str) -> None:
    subprocess.run([sys.executable, os.path.abspath(__file__), mode, path],
                   check=True, cwd=cwd, env=dict(os.environ, PYTHONPATH=root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="directory holding the other checkout's "
                                    "convtasnet_tpu_torch/")
    ap.add_argument("--time", action="store_true",
                    help="also time both trees in turns")
    ap.add_argument("--out", help="write every number here as JSON")
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    ap.add_argument("--time-dump", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.dump:
        dump(a.dump)
        return 0
    if a.time_dump:
        time_tree(a.time_dump)
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
        n_bits = sum(1 for k in outs["other"] if k.startswith(BIT_KEYS))
        n_diff = sum(1 for k in bad if k.startswith(BIT_KEYS))
        print(f"{n_bits - n_diff} of {n_bits} bit-for-bit outputs the same "
              f"bits; {len(bad) - n_diff} TCN outputs past their bars",
              flush=True)
        report["compare"] = lines
        if a.time:
            turns = []
            for i, tree in enumerate(("other", "this", "this", "other")):
                path = os.path.join(tmp, f"time{i}.pt")
                _run("--time-dump", roots[tree], path, tmp)
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
