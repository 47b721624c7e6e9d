#!/usr/bin/env python3
"""Where a bf16 train step's gradient parts from the f32 one: this tree's
kernels against another checkout's, side by side, on one NVIDIA GPU, for
the TCN's block kernels or the DPT's sublayer kernels.

    python3 scripts/step_gate_probe.py --other DIR [--separator dpt] \\
        [--norm cLN] [--chunk 128] [--seeds 11,12 | 11-18] [--twin KIND] \\
        [--tp] [--perturb N] [--blocks] [--out FILE]

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive HEAD convtasnet_tpu_torch``).
Its package is copied under another name into a temporary directory, so
that both trees' kernels load in one process. For the paper config with
``--norm`` (gLN, or cLN causal), or with ``--separator dpt`` the DPT
quality default at chunk length ``--chunk``, bf16, with the seeded init
and batches of ``chip_smoke.py``'s ``phase_step_compare`` (B=4 x 4 s), it
prints:

- per batch seed, the loss and the gradient's relative L2 from the f32
  plain path's, with its ratio to the bf16 plain path's (the statistic
  the smoke's bf16 step gates hold), for the bf16 plain path and for the
  four pairings of the two trees' forward kernels (B1; or B7, B9, B11)
  and backward kernels (B2 / B3; or B8, B10, B12), so that the forward's
  and the backward's shares are told apart;
- ``--twin KIND``: also this tree's kernel path with the forward of
  ``KIND`` (``block``; or ``inter``, ``intra``, ``ffn``) replaced by its
  bf16 plain twin, so that one kernel's share of a reading shows;
- ``--tp``: also each tree's step over two shards on the one card (the
  partial kernels, or B6);
- per seed, the correlation of every (estimate, source) pair of each
  utterance for the f32 path and both trees: the gradient of the
  SI-SNR loss at a pair goes as 1 / correlation, so a pair of the winning
  permutation near zero dominates it;
- ``--perturb N``: N more draws of each tree's kernel path at every seed,
  each kernel's output multiplied by (1 + 2^-11 n), n standard normal,
  before it is rounded back to bf16: about one bf16 rounding step, the
  spread that any two correct bf16 evaluations of the step share;
- ``--blocks``: at the first seed, every block's (or sublayer's) forward
  and backward on the inputs and cotangents this tree's kernel path gave
  it, both trees' kernels and the bf16 twin held against the twin in f64
  (the DPT's twin keeps its LN statistics and softmax in f32, about 1e-7
  off; its weight matrices are rounded to bf16 first, as the kernels take
  them).

``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "convtasnet_tpu_torch"
OTHER = "ctn_other"
SECONDS, SAMPLE_RATE = 4, 8000
ATTN_GRADS = ("dx", "dgamma", "dbeta", "dW_qkv", "dW_out")
# per separator, each kernel site: (kind, module, forward, its twin,
# backward, its twin, the backward's output names)
SITES = {
    "tcn": [("block", "ops.cuda.tcn_block", "fused_tcn_block",
             "fused_tcn_block_reference", "ops.cuda.tcn_block_bwd",
             "fused_tcn_block_bwd", "fused_tcn_block_bwd_reference",
             ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2", "dg1", "db1",
              "dg2", "db2"))],
    "dpt": [("inter", "ops.cuda.dpt_attention", "fused_inter_attention",
             "inter_attention_reference", "ops.cuda.dpt_attention",
             "fused_inter_attention_bwd", "inter_attention_bwd_reference",
             ATTN_GRADS),
            ("intra", "ops.cuda.dpt_intra", "fused_intra_attention",
             "intra_attention_reference", "ops.cuda.dpt_intra",
             "fused_intra_attention_bwd", "intra_attention_bwd_reference",
             ATTN_GRADS),
            ("ffn", "ops.cuda.dpt_ffn", "fused_ffn", "ffn_reference",
             "ops.cuda.dpt_ffn", "fused_ffn_bwd", "ffn_bwd_reference",
             ("dx", "dgamma", "dbeta", "dW_up", "db_up", "dW_down",
              "db_down"))],
}


def parse_seeds(text: str) -> list:
    """``"11-18"`` or ``"11,12,13"`` -> the list of seeds."""
    if "-" in text:
        lo, hi = (int(v) for v in text.split("-"))
        return list(range(lo, hi + 1))
    return [int(v) for v in text.split(",")]


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


def reference_operands(separator: str, x, w) -> list:
    """The operands ``w`` of a block or sublayer for its twin in f64: the
    DPT's weight matrices rounded to x's dtype first (its wrappers hand
    them to the kernels so), every other tensor as it is; None stays."""
    return [None if t is None
            else t.to(x.dtype).double() if separator == "dpt" and t.dim() >= 2
            else t.double() for t in w]


def _batch(torch, seed: int):
    """``chip_smoke.train_batch`` at M=4."""
    T = SECONDS * SAMPLE_RATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(4, T, generator=g, device="cuda"),
            torch.full((4,), T, dtype=torch.int32, device="cuda"),
            torch.randn(4, 2, T, generator=g, device="cuda"),
            torch.ones(4, device="cuda"))


class Probe:
    def __init__(self, other_pkg_root: str, separator: str, norm: str,
                 chunk: int):
        import torch

        sys.path.insert(0, other_pkg_root)
        import convtasnet_tpu_torch.train.train_step as ts

        self.torch, self.ts = torch, ts
        self.separator, self.norm, self.chunk = separator, norm, chunk
        # per site: (kind, this tree's forward and backward modules, the
        # attribute names, the twins, the output names)
        self.sites = []
        self.kernels = {"this": {}, "other": {}}
        self.twins = {}
        for kind, fmod, fname, fref, bmod, bname, bref, names in SITES[
                separator]:
            mods = {tree: (importlib.import_module(f"{pkg}.{fmod}"),
                           importlib.import_module(f"{pkg}.{bmod}"))
                    for tree, pkg in (("this", PKG), ("other", OTHER))}
            self.sites.append((kind, *mods["this"], fname, bname, names))
            for tree, (fm, bm) in mods.items():
                self.kernels[tree][kind] = (getattr(fm, fname),
                                            getattr(bm, bname))
            self.twins[kind] = (getattr(mods["this"][0], fref),
                                getattr(mods["this"][1], bref))
        self.estimate = None
        loss_fn = ts.pit_si_snr

        def spy(sources, estimate, lengths):
            self.estimate = estimate.detach().float().clone()
            return loss_fn(sources, estimate, lengths)

        ts.pit_si_snr = spy

    def config(self, dtype: str):
        from convtasnet_tpu_torch import ConvTasNetConfig

        if self.separator == "dpt":
            return ConvTasNetConfig(separator="dpt", compute_dtype=dtype,
                                    dpt_chunk=self.chunk)
        return ConvTasNetConfig(separator="tcn", compute_dtype=dtype,
                                norm_type=self.norm,
                                causal=self.norm == "cLN")

    def step(self, dtype: str, batch, fwd=None, bwd=None, on_fwd=None,
             on_bwd=None, shards: int = 1):
        """Loss, flat gradient and estimate of one step; ``fwd`` / ``bwd``
        map each kind to its kernel on the kernel path (None: the plain
        path); ``on_fwd(kind, args, kw, out)`` may replace a kernel's
        output and ``on_bwd(kind, args, kw)`` sees each backward call;
        ``shards`` 2 takes the step through ``tp_loss_and_grads``."""
        from convtasnet_tpu_torch import SolverConfig
        from convtasnet_tpu_torch.models.conv_tasnet import init_params

        torch = self.torch
        cfg = self.config(dtype)
        sd = init_params(cfg, torch.Generator().manual_seed(0))
        state = self.ts.create_train_state(
            cfg, SolverConfig(), device="cuda", use_pallas=fwd is not None,
            state_dict=sd)
        saved = [(fm, fname, getattr(fm, fname), bm, bname, getattr(bm, bname))
                 for _, fm, bm, fname, bname, _ in self.sites]
        if fwd is not None:
            for kind, fm, bm, fname, bname, _ in self.sites:
                def f(*args, kind=kind, **kw):
                    out = fwd[kind](*args, **kw)
                    return on_fwd(kind, args, kw, out) if on_fwd else out

                def b(*args, kind=kind, **kw):
                    if on_bwd:
                        on_bwd(kind, args, kw)
                    return bwd[kind](*args, **kw)

                # the wrappers count launches on the module's function
                for fn in (f, b):
                    fn.launches = fn.partial_launches = fn.cln_launches = 0
                setattr(fm, fname, f)
                setattr(bm, bname, b)
        try:
            if shards > 1:
                from convtasnet_tpu_torch.parallel.mesh import shard_devices
                from convtasnet_tpu_torch.parallel.tensor_parallel import (
                    tp_loss_and_grads,
                )

                loss = float(tp_loss_and_grads(cfg, state.model, batch,
                                               shard_devices(shards, "cuda")))
            else:
                loss = float(self.ts._loss_and_grads(state.model, batch, 0))
        finally:
            for fm, fname, f0, bm, bname, b0 in saved:
                setattr(fm, fname, f0)
                setattr(bm, bname, b0)
        grad = torch.cat([p.grad.detach().double().reshape(-1)
                          for p in state.model.parameters()])
        return loss, grad, self.estimate

    def seeds(self, seeds, n_perturb: int, twin: str = None,
              tp: bool = False) -> dict:
        torch = self.torch
        out = {}
        for seed in seeds:
            batch = _batch(torch, seed)
            lf, gf, ef = self.step("float32", batch)
            lp, gp, _ = self.step("bfloat16", batch)
            plain = rel_l2(gp, gf)
            row = {"f32_loss": lf, "plain": [lp, plain],
                   "gate": max(8e-2, 1.25 * plain)}

            def reading(loss, g):
                d = rel_l2(g, gf)
                return [loss, d, d / plain]

            corr = {"f32": pair_correlations(batch[2], ef)}
            ests = {}
            for fn in ("this", "other"):
                for bn in ("this", "other"):
                    loss, g, e = self.step(
                        "bfloat16", batch,
                        {k: v[0] for k, v in self.kernels[fn].items()},
                        {k: v[1] for k, v in self.kernels[bn].items()})
                    row[f"fwd {fn} / bwd {bn}"] = reading(loss, g)
                    if fn == bn:
                        ests[fn] = e
                        corr[fn] = pair_correlations(batch[2], e)
            if twin:
                fwd = {k: v[0] for k, v in self.kernels["this"].items()}
                fwd[twin] = self.twins[twin][0]
                loss, g, _ = self.step(
                    "bfloat16", batch, fwd,
                    {k: v[1] for k, v in self.kernels["this"].items()})
                row[f"fwd this, {twin} as its twin / bwd this"] = reading(
                    loss, g)
            for tree in ("this", "other") if tp else ():
                loss, g, _ = self.step(
                    "bfloat16", batch,
                    {k: v[0] for k, v in self.kernels[tree].items()},
                    {k: v[1] for k, v in self.kernels[tree].items()},
                    shards=2)
                row[f"TP m=2 {tree}"] = reading(loss, g)
            row["estimate from f32"] = {k: rel_l2(e, ef)
                                        for k, e in ests.items()}
            row["estimates apart"] = rel_l2(ests["this"], ests["other"])
            row["correlations"] = {k: v.tolist() for k, v in corr.items()}
            for tree in ("this", "other") if n_perturb else ():
                draws = []
                for i in range(n_perturb):
                    gen = torch.Generator(device="cuda").manual_seed(1000 + i)

                    def nudge(kind, args, kw, y, gen=gen):
                        n = torch.randn(y.shape, generator=gen, device="cuda")
                        return (y.float() * (1 + 2.0 ** -11 * n)).to(y.dtype)

                    loss, g, _ = self.step(
                        "bfloat16", batch,
                        {k: v[0] for k, v in self.kernels[tree].items()},
                        {k: v[1] for k, v in self.kernels[tree].items()},
                        on_fwd=nudge)
                    draws.append(reading(loss, g))
                row[f"perturbed {tree}"] = draws
                ratios = [r[2] for r in draws]
                row[f"perturbed {tree} ratios"] = {
                    "min": min(ratios), "median": statistics.median(ratios),
                    "max": max(ratios)}
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
        this = self.kernels["this"]
        names = {site[0]: site[-1] for site in self.sites}
        ins, cots = [], []

        def keep_in(kind, args, kw, y):
            ins.append((kind, [None if a is None else a.detach().clone()
                               for a in args], dict(kw)))
            return y

        self.step("bfloat16", _batch(torch, seed),
                  {k: v[0] for k, v in this.items()},
                  {k: v[1] for k, v in this.items()}, on_fwd=keep_in,
                  on_bwd=lambda kind, args, kw: cots.append(
                      (kind, args[1].clone())))
        rows = []
        with torch.no_grad():
            for i, ((kind, args, kw), (gkind, g)) in enumerate(
                    zip(ins, reversed(cots))):
                assert kind == gkind, (i, kind, gkind)
                fwd_ref, bwd_ref = self.twins[kind]
                x, w = args[0], args[1:]
                wd = reference_operands(self.separator, x, w)
                delta = fwd_ref(x.double(), *wd, **kw) - x.double()

                def err(y):
                    return rel_l2(y.double() - x.double(), delta)

                y_this = this[kind][0](x, *w, **kw)
                y_other = self.kernels["other"][kind][0](x, *w, **kw)
                row = {"index": i, "kind": kind,
                       **{k: v for k, v in kw.items()
                          if isinstance(v, int) and not isinstance(v, bool)},
                       "forward from f64": {
                           "this": err(y_this), "other": err(y_other),
                           "bf16 twin": err(fwd_ref(x, *w, **kw))},
                       "forward trees apart": rel_l2(
                           y_this.double() - x.double(),
                           y_other.double() - x.double())}
                want = bwd_ref(x.double(), g.double(), *wd, **kw)
                got = {"this": this[kind][1](x, g, *w, **kw),
                       "other": self.kernels["other"][kind][1](x, g, *w,
                                                               **kw),
                       "bf16 twin": bwd_ref(x, g, *w, **kw)}
                # db_down and other all-zero references have no relative L2
                row["backward from f64"] = {
                    k: {n: rel_l2(q, r) for n, q, r in zip(names[kind], v,
                                                           want)
                        if r.double().norm() > 0}
                    for k, v in got.items()}
                row["backward trees apart"] = max(
                    rel_l2(q, r) for q, r in zip(got["this"], got["other"])
                    if r.double().norm() > 0)
                print(json.dumps(row), flush=True)
                rows.append(row)
        return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="a checkout holding convtasnet_tpu_torch/")
    ap.add_argument("--separator", default="tcn", choices=tuple(SITES))
    ap.add_argument("--norm", default="cLN", choices=("gLN", "cLN"))
    ap.add_argument("--chunk", type=int, default=128,
                    help="the DPT's chunk length (--dpt-chunk)")
    ap.add_argument("--seeds", default="11,12")
    ap.add_argument("--twin", default=None,
                    help="a kind whose forward also runs as its bf16 twin")
    ap.add_argument("--tp", action="store_true",
                    help="also the step over two shards")
    ap.add_argument("--perturb", type=int, default=0)
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    kinds = [site[0] for site in SITES[a.separator]]
    if a.twin is not None and a.twin not in kinds:
        ap.error(f"--twin takes one of {kinds} with --separator "
                 f"{a.separator}")
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        rename_package(os.path.join(os.path.abspath(a.other), PKG), tmp,
                       OTHER)
        probe = Probe(tmp, a.separator, a.norm, a.chunk)
        seeds = parse_seeds(a.seeds)
        result = {"seeds": probe.seeds(seeds, a.perturb, a.twin, a.tp)}
        if a.blocks:
            result["blocks"] = probe.blocks(seeds[0])
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
