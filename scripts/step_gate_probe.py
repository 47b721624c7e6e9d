#!/usr/bin/env python3
"""Where a bf16 train step's gradient parts from the f32 one: this tree's
TCN block kernels against another checkout's, side by side, on one NVIDIA
GPU.

    python3 scripts/step_gate_probe.py --other DIR [--norm cLN] \\
        [--seeds 11,12] [--perturb N] [--blocks] [--out FILE]

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive HEAD convtasnet_tpu_torch``).
Its package is copied under another name into a temporary directory, so
that both trees' kernels load in one process. For the paper config with
``--norm`` (gLN, or cLN causal), bf16, the seeded init and batches of
``chip_smoke.py``'s ``phase_step_compare`` (B=4 x 4 s), it prints:

- per batch seed, the loss and the gradient's relative L2 from the f32
  plain path's, for the bf16 plain path and for the four pairings of the
  two trees' block forward (B1) and backward (B2 / B3), so that the
  forward's and the backward's shares are told apart;
- per seed, the correlation of every (estimate, source) pair of each
  utterance for the f32 path and both trees: the gradient of the
  SI-SNR loss at a pair goes as 1 / correlation, so a pair of the winning
  permutation near zero dominates it;
- ``--perturb N``: N more draws of each tree's kernel path at every seed,
  each block's output multiplied by (1 + 2^-11 n), n standard normal,
  before it is rounded back to bf16: about one bf16 rounding step, the
  spread that any two correct bf16 evaluations of the step share;
- ``--blocks``: at the first seed, every block's forward and backward on
  the inputs and cotangents this tree's kernel path gave it, both trees'
  kernels and the bf16 twin held against the twin in f64.

``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "convtasnet_tpu_torch"
OTHER = "ctn_other"
SECONDS, SAMPLE_RATE = 4, 8000
NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2", "dg1", "db1",
         "dg2", "db2")


def rename_package(src: str, root: str, name: str) -> str:
    """Copy the package directory ``src`` to ``root/name``, its own
    imports of ``convtasnet_tpu_torch`` rewritten to ``name``, without its
    build outputs; returns the new package directory."""
    dst = os.path.join(root, name)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    pat = re.compile(rf"\b{PKG}\b")
    for base, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    text = fh.read()
                with open(path, "w") as fh:
                    fh.write(pat.sub(name, text))
    return dst


def pair_correlations(sources, estimates):
    """[B, C, T] sources and estimates -> [B, C, C] correlations of the
    zero-mean estimate i with the zero-mean source j (the cosine that the
    SI-SNR of the pair is 10 log10(c^2 / (1 - c^2)) of)."""
    s = sources.double()
    e = estimates.double()
    s = s - s.mean(dim=2, keepdim=True)
    e = e - e.mean(dim=2, keepdim=True)
    dot = e @ s.transpose(1, 2)
    return dot / (e.norm(dim=2)[:, :, None] * s.norm(dim=2)[:, None, :])


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _batch(torch, seed: int):
    """``chip_smoke.train_batch`` at M=4."""
    T = SECONDS * SAMPLE_RATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(4, T, generator=g, device="cuda"),
            torch.full((4,), T, dtype=torch.int32, device="cuda"),
            torch.randn(4, 2, T, generator=g, device="cuda"),
            torch.ones(4, device="cuda"))


class Probe:
    def __init__(self, other_pkg_root: str, norm: str):
        import torch

        sys.path.insert(0, other_pkg_root)
        import convtasnet_tpu_torch.ops.cuda.tcn_block as fwd_mod
        import convtasnet_tpu_torch.ops.cuda.tcn_block_bwd as bwd_mod
        import convtasnet_tpu_torch.train.train_step as ts

        other_f = __import__(f"{OTHER}.ops.cuda.tcn_block",
                             fromlist=["x"])
        other_b = __import__(f"{OTHER}.ops.cuda.tcn_block_bwd",
                             fromlist=["x"])
        self.torch, self.ts, self.norm = torch, ts, norm
        self.fwd_mod, self.bwd_mod = fwd_mod, bwd_mod
        self.kernels = {
            "this": (fwd_mod.fused_tcn_block, bwd_mod.fused_tcn_block_bwd),
            "other": (other_f.fused_tcn_block,
                      other_b.fused_tcn_block_bwd)}
        self.estimate = None
        loss_fn = ts.pit_si_snr

        def spy(sources, estimate, lengths):
            self.estimate = estimate.detach().float().clone()
            return loss_fn(sources, estimate, lengths)

        ts.pit_si_snr = spy

    def step(self, dtype: str, batch, fwd=None, bwd=None, on_fwd=None,
             on_bwd=None):
        """Loss, flat gradient and estimate of one step; ``fwd`` / ``bwd``
        the block kernels of the kernel path (None: the plain path);
        ``on_fwd(args, kw, out)`` may replace a block's output and
        ``on_bwd(args, kw)`` sees each backward call."""
        from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
        from convtasnet_tpu_torch.models.conv_tasnet import init_params

        torch = self.torch
        cfg = ConvTasNetConfig(separator="tcn", compute_dtype=dtype,
                               norm_type=self.norm,
                               causal=self.norm == "cLN")
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        state = self.ts.create_train_state(
            cfg, SolverConfig(), device="cuda", use_pallas=fwd is not None,
            state_dict=sd)
        saved = (self.fwd_mod.fused_tcn_block,
                 self.bwd_mod.fused_tcn_block_bwd)
        if fwd is not None:
            def f(*args, **kw):
                out = fwd(*args, **kw)
                return on_fwd(args, kw, out) if on_fwd else out

            def b(*args, **kw):
                if on_bwd:
                    on_bwd(args, kw)
                return bwd(*args, **kw)

            # the wrappers count launches on the module's function
            f.launches = b.launches = b.cln_launches = 0
            self.fwd_mod.fused_tcn_block = f
            self.bwd_mod.fused_tcn_block_bwd = b
        try:
            loss = float(self.ts._loss_and_grads(state.model, batch, 0))
        finally:
            (self.fwd_mod.fused_tcn_block,
             self.bwd_mod.fused_tcn_block_bwd) = saved
        grad = torch.cat([p.grad.detach().double().reshape(-1)
                          for p in state.model.parameters()])
        return loss, grad, self.estimate

    def seeds(self, seeds, n_perturb: int) -> dict:
        torch = self.torch
        out = {}
        for seed in seeds:
            batch = _batch(torch, seed)
            lf, gf, ef = self.step("float32", batch)
            lp, gp, _ = self.step("bfloat16", batch)
            row = {"f32_loss": lf, "plain": [lp, rel_l2(gp, gf)],
                   "gate": max(8e-2, 1.25 * rel_l2(gp, gf))}
            corr = {"f32": pair_correlations(batch[2], ef)}
            ests = {}
            for fn in ("this", "other"):
                for bn in ("this", "other"):
                    loss, g, e = self.step("bfloat16", batch,
                                           self.kernels[fn][0],
                                           self.kernels[bn][1])
                    row[f"fwd {fn} / bwd {bn}"] = [loss, rel_l2(g, gf)]
                    if fn == bn:
                        ests[fn] = e
                        corr[fn] = pair_correlations(batch[2], e)
            row["estimate from f32"] = {k: rel_l2(e, ef)
                                        for k, e in ests.items()}
            row["estimates apart"] = rel_l2(ests["this"], ests["other"])
            row["correlations"] = {k: v.tolist() for k, v in corr.items()}
            for tree in ("this", "other") if n_perturb else ():
                draws = []
                for i in range(n_perturb):
                    gen = torch.Generator(device="cuda").manual_seed(1000 + i)

                    def nudge(args, kw, y, gen=gen):
                        n = torch.randn(y.shape, generator=gen, device="cuda")
                        return (y.float() * (1 + 2.0 ** -11 * n)).to(y.dtype)

                    loss, g, _ = self.step("bfloat16", batch,
                                           *self.kernels[tree], on_fwd=nudge)
                    draws.append([loss, rel_l2(g, gf)])
                row[f"perturbed {tree}"] = draws
            print(f"seed {seed}: " + json.dumps(
                {k: v for k, v in row.items() if k != "correlations"}),
                flush=True)
            for k, v in corr.items():
                print(f"seed {seed} correlations [utterance, estimate, "
                      f"source] {k}: " + json.dumps(
                          [[[f"{c:.3e}" for c in r] for r in u]
                           for u in v.tolist()]), flush=True)
            out[str(seed)] = row
        return out

    def blocks(self, seed: int) -> list:
        torch = self.torch
        fwd_ref = self.fwd_mod.fused_tcn_block_reference
        bwd_ref = self.bwd_mod.fused_tcn_block_bwd_reference
        ins, cots = [], []

        def keep_in(args, kw, y):
            ins.append(([a.detach().clone() for a in args], dict(kw)))
            return y

        self.step("bfloat16", _batch(torch, seed), *self.kernels["this"],
                  on_fwd=keep_in,
                  on_bwd=lambda args, kw: cots.append(args[1].clone()))
        rows = []
        with torch.no_grad():
            for i, ((args, kw), g) in enumerate(zip(ins, reversed(cots))):
                x, w = args[0], args[1:]
                wd = [t.double() for t in w]
                delta = fwd_ref(x.double(), *wd, **kw) - x.double()

                def err(y):
                    return rel_l2(y.double() - x.double(), delta)

                y_this = self.kernels["this"][0](x, *w, **kw)
                y_other = self.kernels["other"][0](x, *w, **kw)
                row = {"block": i, "dilation": kw["dilation"],
                       "forward from f64": {
                           "this": err(y_this), "other": err(y_other),
                           "bf16 twin": err(fwd_ref(x, *w, **kw))},
                       "forward trees apart": rel_l2(
                           y_this.double() - x.double(),
                           y_other.double() - x.double())}
                want = bwd_ref(x.double(), g.double(), *wd, **kw)
                got = {"this": self.kernels["this"][1](x, g, *w, **kw),
                       "other": self.kernels["other"][1](x, g, *w, **kw),
                       "bf16 twin": bwd_ref(x, g, *w, **kw)}
                row["backward from f64"] = {
                    k: {n: rel_l2(q, r) for n, q, r in zip(NAMES, v, want)}
                    for k, v in got.items()}
                row["backward trees apart"] = max(
                    rel_l2(q, r) for q, r in zip(got["this"], got["other"]))
                print(json.dumps(row), flush=True)
                rows.append(row)
        return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="a checkout holding convtasnet_tpu_torch/")
    ap.add_argument("--norm", default="cLN", choices=("gLN", "cLN"))
    ap.add_argument("--seeds", default="11,12")
    ap.add_argument("--perturb", type=int, default=0)
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as tmp:
        rename_package(os.path.join(os.path.abspath(a.other), PKG), tmp,
                       OTHER)
        probe = Probe(tmp, a.norm)
        seeds = [int(s) for s in a.seeds.split(",")]
        result = {"seeds": probe.seeds(seeds, a.perturb)}
        if a.blocks:
            result["blocks"] = probe.blocks(seeds[0])
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
