#!/usr/bin/env python3
"""The DPT intra kernels (B9 forward, B10 backward) of this tree against
those of another checkout, bit for bit, on one NVIDIA GPU.

    python3 scripts/intra_vs_parent.py --other DIR

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive``). Each tree's package runs in
a subprocess of its own (``--dump``), builds its kernels from its own
sources and writes its outputs at the shapes both trees take; this
process compares them with ``torch.equal``. A change that moves tiles
between shared memory and a device workspace must leave these bits as
they were. Exits nonzero if any output differs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dtype, S, heads at B = 256, run the forward, run the backward): shapes
# whose tiles fitted in shared memory before the workspace spill of the
# [S, d] tiles, or spilled only the backward's [S, S] tiles
CASES = [("bfloat16", 128, 8, True, True),
         ("bfloat16", 256, 4, True, True),
         ("float32", 128, 8, True, True),
         ("float32", 176, 4, True, True),
         ("float32", 208, 4, False, True)]


def dump(path: str) -> None:
    import torch

    from convtasnet_tpu_torch.ops.cuda import dpt_intra

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dtype, S, heads, fwd, bwd in CASES:
        g = torch.Generator(device="cuda").manual_seed(S + heads)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        B, n, M = 256, 3199 // S + 1, 8
        dt = getattr(torch, dtype)
        valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
        x = rn(M, n, S, B).to(dt)
        w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, 3 * B, scale=B ** -0.5),
             rn(B, B, scale=B ** -0.5),
             torch.where(valid, 0.0, -1e9).to(torch.float32))
        key = f"{dtype} S={S} heads={heads}"
        if fwd:
            with torch.inference_mode():
                out[f"{key} forward"] = dpt_intra.fused_intra_attention(
                    x, w[0], w[1], w[2].to(dt), w[3].to(dt), w[4],
                    n_heads=heads).cpu()
        if bwd:
            gr = (rn(M, n * S, B) * valid.reshape(1, -1, 1)).reshape(
                x.shape).to(dt)
            grads = dpt_intra.fused_intra_attention_bwd(x, gr, *w,
                                                        n_heads=heads)
            for i, t in enumerate(grads):
                out[f"{key} backward {i}"] = t.cpu()
        torch.cuda.synchronize()
    torch.save(out, path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="directory holding the other checkout's "
                                    "convtasnet_tpu_torch/")
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.dump:
        dump(a.dump)
        return 0
    import torch

    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, root in (("this tree", REPO),
                           ("other", os.path.abspath(a.other))):
            path = os.path.join(tmp, f"{len(outs)}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--dump", path], check=True, cwd=tmp,
                           env=dict(os.environ, PYTHONPATH=root))
            outs[name] = torch.load(path)
    mine, other = outs["this tree"], outs["other"]
    differ = [k for k in other if not torch.equal(mine[k], other[k])]
    for k in other:
        print(f"intra kernels vs the other checkout, {k}: "
              f"{'same bits' if k not in differ else 'DIFFERENT'}",
              flush=True)
    print(f"{len(other) - len(differ)} of {len(other)} outputs the same bits",
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
