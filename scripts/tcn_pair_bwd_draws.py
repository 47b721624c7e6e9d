#!/usr/bin/env python3
"""How far the bf16 pair backward (B5) reads from exact f32 over batch
seeds, at P taps against P = 3, on one NVIDIA GPU.

    python3 scripts/tcn_pair_bwd_draws.py [--P 31] [--d1 64] [--seeds 0-11]

For each seed, the operands of ``tests/test_torch_cuda.py``'s pair cases
(M = 2, K = 300, B = 64, H = 128, gLN, non-causal, (d1, 2 d1)) with P taps
(the test's ``_with_taps``), B5 at a random cotangent against the pair's
twin in f32 (exact) and in bf16: for the cotangents but the slopes, the
largest ratio of B5's distance from exact to the card test's bar
(max(8e-2, 1.25x the bf16 twin's distance)), at P and at P = 3; and
whether B5 at P gives the bits of B5 at the taps that reach a row in
range (its center taps, where the others are out of range for every row:
the first routes, P <= 16). A ratio above 1 at one seed is one draw of
bf16 rounding where its spread over the seeds matches P = 3's.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=31)
    ap.add_argument("--d1", type=int, default=64)
    ap.add_argument("--seeds", default="0-11")
    a = ap.parse_args()
    import torch

    import test_torch_cuda as t
    from convtasnet_tpu_torch.ops.cuda import tcn_block_pair_bwd as pair_bwd

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lo, hi = (int(v) for v in a.seeds.split("-"))
    names = ["dx"] + [f"{blk} {n}" for blk in "ab" for n in t.NAMES[1:]]
    # the taps that reach a row of K = 300 at d1 (block 2's, at 2 d1, are
    # among them)
    reach = (300 - 1) // a.d1
    center = slice(a.P // 2 - reach, a.P // 2 + reach + 1)
    kw = dict(d1=a.d1, d2=2 * a.d1, causal=False)

    def run(P, seed, cut=None):
        x, pa, pb, g = t._pair_args(cuda, torch.bfloat16, seed=seed)
        pa = list(t._with_taps([x, *pa], P)[1:])
        pb = list(t._with_taps([x, *pb], P, 8)[1:])
        if cut is not None:
            pa[1], pb[1] = pa[1][cut].contiguous(), pb[1][cut].contiguous()
        got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
        exact = pair_bwd.fused_tcn_block_pair_bwd_reference(
            x.float(), g.float(), [u.float() for u in pa],
            [u.float() for u in pb], **kw)
        twin = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb,
                                                           **kw)
        return [(o[0], *o[1], *o[2]) for o in (got, exact, twin)]

    def worst(got, exact, twin):
        ratio = {n: t._rel_l2(q, e) / max(0.08, 1.25 * t._rel_l2(w, e))
                 for n, q, e, w in zip(names, got, exact, twin)
                 if n.split()[-1] not in t.SLOPES}
        top = max(ratio, key=ratio.get)
        return top, ratio[top]

    print(f"B5 bf16 at P = {a.P}, ({a.d1}, {2 * a.d1}); center taps "
          f"{center.start}..{center.stop - 1}", flush=True)
    for seed in range(lo, hi + 1):
        got, exact, twin = run(a.P, seed)
        narrow = run(a.P, seed, center)[0]
        same = all(torch.equal(u[center] if i in (2, 11) else u, v)
                   for i, (u, v) in enumerate(zip(got, narrow)))
        n, r = worst(got, exact, twin)
        n3, r3 = worst(*run(3, seed))
        print(f"seed {seed}: P = {a.P} the bits of its center taps {same}; "
              f"distance / bar {r:.3f} ({n}); at P = 3 {r3:.3f} ({n3})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
