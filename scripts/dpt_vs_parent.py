#!/usr/bin/env python3
"""The DPT sublayer kernels in full mode (B7-B12) of this tree against
those of another checkout, bit for bit, on one NVIDIA GPU.

    python3 scripts/dpt_vs_parent.py --other DIR

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive``). Each tree's package runs in
a subprocess of its own (``--dump``), builds its kernels from its own
sources and writes its outputs at shapes both trees take: each sublayer's
forward and backward at the DPT quality default's widths ([8, 25, 128,
256], 8 heads, F=1024, the real key mask), bf16 and f32, and the intra
kernels at the chunk lengths whose tiles sit in shared memory or spill to
the device workspace. This process compares them with ``torch.equal``. A
change to the kernels' shared pieces (a width parameter, a mode flag, a
tile moved to the workspace) must leave the full sublayers' bits as they
were. Exits nonzero if any output differs.
"""

from __future__ import annotations

import argparse
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


def dump(path: str) -> None:
    import torch

    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra

    fns = {"inter": (dpt_attention.fused_inter_attention,
                     dpt_attention.fused_inter_attention_bwd),
           "intra": (dpt_intra.fused_intra_attention,
                     dpt_intra.fused_intra_attention_bwd),
           "ffn": (dpt_ffn.fused_ffn, dpt_ffn.fused_ffn_bwd)}
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for kind, dtype, S, heads, fwd, bwd in CASES:
        g = torch.Generator(device="cuda").manual_seed(S + heads)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        B, F, n, M = 256, 1024, 3199 // S + 1, 8
        dt = getattr(torch, dtype)
        valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
        x = rn(M, n, S, B).to(dt)
        if kind == "ffn":
            x = x.reshape(M, n * S, B)
            w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, F, scale=B ** -0.5),
                 0.1 * rn(F), rn(F, B, scale=F ** -0.5), 0.1 * rn(B))
            kw = {}
        else:
            w = (1.0 + 0.1 * rn(B), 0.1 * rn(B),
                 rn(B, 3 * B, scale=B ** -0.5), rn(B, B, scale=B ** -0.5),
                 torch.where(valid, 0.0, -1e9).to(torch.float32))
            kw = dict(n_heads=heads)
        key = f"{kind} {dtype} S={S} heads={heads}"
        fused, fused_bwd = fns[kind]
        if fwd:
            with torch.inference_mode():
                out[f"{key} forward"] = fused(x, *w, **kw).cpu()
        if bwd:
            gr = (rn(M, n * S, B) * valid.reshape(1, -1, 1)).reshape(
                x.shape).to(dt)
            for i, t in enumerate(fused_bwd(x, gr, *w, **kw)):
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
        print(f"DPT kernels vs the other checkout, {k}: "
              f"{'same bits' if k not in differ else 'DIFFERENT'}",
              flush=True)
    print(f"{len(other) - len(differ)} of {len(other)} outputs the same bits",
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
