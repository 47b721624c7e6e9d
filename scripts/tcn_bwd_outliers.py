#!/usr/bin/env python3
"""Where the f32 outliers of the TCN block backwards come from. Needs one
CUDA GPU and nvcc.

    PYTHONPATH=. python3 scripts/tcn_bwd_outliers.py

``chip_smoke.py``'s random-cotangent check reads f32 cases far above the
rest (~7e-7): kernel B2 (gLN) at d=32, kernel B3 (cLN, causal) at d=2 and
B3 on the 3xTF32 stages at d=128, non-causal. This reruns those cases, and
the pair backward B5 at (16, 32), on the smoke's own inputs, against the
exact f32 cotangents (B3 also against the f64 block, with both slope
gradients' values, and against the f64 block under the nearest branches
of the pre-activations within f32 rounding of 0, ``f64_nearest_branches``
with a wider net than the smoke's, each element tried printed with its
distance from 0 and its effect on the slopes), first with the smoke's
PReLU slopes and then with every slope set to 1, where PReLU is the
identity and no pre-activation can take the other branch. For each it
prints every cotangent's relative L2 error and the largest |dx - exact|
elements, each with the smallest |pre-activation| of its row: h_pre = x @
W_in and c, the depthwise conv's output, of each block (from the f32 twin
math). If an outlier vanishes with the slopes at 1 and its largest errors
sit on rows with a pre-activation within rounding of 0, it is a PReLU
branch flip, not a fault of the kernel.

Last, on the inputs of the card test that holds f32 B3
(``tests/test_torch_cuda.py::test_f32_stages_backward_cln``, shape for
shape), each cotangent's distance from the f64 block, for the kernel and
for its f32 twin.
"""

from __future__ import annotations

import os
import sys

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pre_activations(torch, x, w, d, causal, norm):
    """(h_pre, c) of one block in f32 from its input and weights."""
    from convtasnet_tpu_torch.ops.conv import depthwise_conv1d
    from convtasnet_tpu_torch.ops.norm import (
        channelwise_layer_norm,
        global_layer_norm,
    )

    w_in, dw, _, a1, _, g1, b1, _, _ = [t.float() for t in w]
    hp = x.float() @ w_in
    h1 = torch.where(hp >= 0, hp, a1 * hp)
    ln = global_layer_norm if norm == "gLN" else channelwise_layer_norm
    c = depthwise_conv1d(ln(h1, g1, b1), dw, d, causal)
    return hp, c


def report(torch, label, names, got, exact, rows):
    """Every cotangent's error, and the 8 largest |dx - exact| with the
    smallest |h_pre| and |c| of their row in each block (rows: a list of
    (block, hp, c))."""
    errs = {n: cs.rel_l2(q, r) for n, q, r in zip(names, got, exact)}
    top = max(errs, key=errs.get)
    print(f"{label}: worst {top} {errs[top]:.3e}; "
          + ", ".join(f"{n} {v:.2e}" for n, v in errs.items()), flush=True)
    diff = (got[0].float() - exact[0].float()).abs()
    vals, idx = diff.reshape(-1).topk(8)
    M, K, B = diff.shape
    for v, i in zip(vals.tolist(), idx.tolist()):
        m, k, b = i // (K * B), (i // B) % K, i % B
        at = "; ".join(
            f"{blk} min|h_pre| {hp[m, k].abs().min().item():.2e} min|c| "
            f"{c[m, k].abs().min().item():.2e}" for blk, hp, c in rows)
        print(f"    dx[{m},{k},{b}] off by {v:.3e} (|exact| "
              f"{exact[0][m, k, b].abs().item():.3e}); {at}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tcn_bwd_outliers: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = cs.tcn_modules()
    bwd, pair_bwd, tcn = k["bwd"], k["pair_bwd"], k["tcn"]
    one = torch.tensor(1.0, device="cuda")
    for norm, d, causal in (("gLN", 32, False), ("cLN", 2, True),
                            ("cLN", 128, False)):
        x, *w = cs.block_inputs(torch, torch.float32, d)
        g = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(2000 + d), device="cuda")
        kw = dict(dilation=d, causal=causal, norm_type=norm)
        for slopes in ("the smoke's", "all 1"):
            ws = list(w)
            if slopes == "all 1":
                ws[3], ws[4] = one, one
            got = bwd.fused_tcn_block_bwd(x, g, *ws, **kw)
            exact = bwd.fused_tcn_block_bwd_reference(x, g, *ws, **kw)
            torch.cuda.synchronize()
            hp, c = pre_activations(torch, x, ws, d, causal, norm)
            label = (f"{'B2' if norm == 'gLN' else 'B3'} {norm} d={d} "
                     f"causal={int(causal)} f32, slopes {slopes}")
            report(torch, label, cs.GRAD_NAMES, got, exact,
                   [("block", hp, c)])
            if norm == "cLN":
                near, f64, note = cs.f64_nearest_branches(
                    torch, x, g, ws, d, causal, norm, got, 4e-3,
                    roundings=16.0, most=12)
                report(torch, f"{label}, against the f64 block",
                       cs.GRAD_NAMES, got, f64, [("block", hp, c)])
                report(torch, f"{label}, against the f64 block's nearest "
                       "branches", cs.GRAD_NAMES, got, near,
                       [("block", hp, c)])
                print(f"    f64 branches: {note}", flush=True)
                print("    da1, da2: kernel " + ", ".join(
                    f"{got[i].item():.6f}" for i in (4, 5)) + "; f32 twin "
                    + ", ".join(f"{exact[i].item():.6f}" for i in (4, 5))
                    + "; f64 " + ", ".join(f"{f64[i].item():.6f}"
                                           for i in (4, 5))
                    + "; f64 nearest branches " + ", ".join(
                        f"{near[i].item():.6f}" for i in (4, 5)), flush=True)
    d1, d2 = 16, 32
    x, pa, pb = cs.pair_inputs(torch, torch.float32, d1)
    g = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(2000 + d1), device="cuda")
    for slopes in ("the smoke's", "all 1"):
        qa, qb = list(pa), list(pb)
        if slopes == "all 1":
            qa[3] = qa[4] = qb[3] = qb[4] = one
        kw = dict(d1=d1, d2=d2, causal=False)
        got = pair_bwd.fused_tcn_block_pair_bwd(x, g, qa, qb, **kw)
        exact = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, qa, qb,
                                                            **kw)
        x1 = tcn.fused_tcn_block_reference(x, *qa, dilation=d1, causal=False,
                                           norm_type="gLN")
        torch.cuda.synchronize()
        rows = [("block 1", *pre_activations(torch, x, qa, d1, False, "gLN")),
                ("block 2", *pre_activations(torch, x1, qb, d2, False, "gLN"))]
        report(torch, f"B5 gLN d=({d1},{d2}) f32, slopes {slopes}",
               cs.PAIR_GRAD_NAMES, cs.pair_grads(got), cs.pair_grads(exact),
               rows)
    card_test_shapes(torch)
    return 0


def card_test_shapes(torch):
    """f32 B3 and its f32 twin against the f64 block on the card test's
    inputs, seed for seed."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_cuda as tc

    for b, h, p, d, causal in tc.F32_CLN_BWD_SHAPES:
        x, *w = tc._f32_stage_args("cuda", b, h, p, 60 + d, a2=-0.2)
        g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(100 + d))
        kw = dict(dilation=d, causal=causal, norm_type="cLN")
        got = tc.port_bwd.fused_tcn_block_bwd(x, g, *w, **kw)
        twin = tc.port_bwd.fused_tcn_block_bwd_reference(x, g, *w, **kw)
        exact = cs.f64_block_grads(torch, x, g, w, d, causal, "cLN")
        label = f"card test B={b} H={h} P={p} d={d} causal={int(causal)}"
        for who, grads in (("kernel", got), ("f32 twin", twin)):
            errs = {n: cs.rel_l2(q, r)
                    for n, q, r in zip(cs.GRAD_NAMES, grads, exact)}
            worst = max(errs, key=errs.get)
            print(f"{label} {who} from f64: worst {worst} {errs[worst]:.3e}; "
                  + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
