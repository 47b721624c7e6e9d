#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each raising on failure (so the script exits nonzero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the TCN-block CUDA kernels from ``convtasnet_tpu_torch/csrc``;
3. kernel 1 (block forward) against its plain PyTorch twin at the serving
   shape ([8, 3199, 256], H=512), every dilation 1..128, gLN, bf16 and f32,
   at the relative-L2 bars of the JAX package's Pallas probe gate
   (4e-2 / 2e-3);
4. kernel 2 (gLN block backward) against its twin (autograd through the
   plain block) at the same shape and dilations, bf16 and f32, plus a
   causal case and one with a negative PReLU slope: all ten cotangents
   finite and within the JAX train gate (loss = sum of the output, twice
   the forward's bars: 8e-2 / 4e-3); and with a random cotangent, against
   the exact (f32) cotangents: all ten within 4e-3 in f32, the eight
   besides the two PReLU slopes within 8e-2 in bf16;
5. the serving path: ``separate`` on four seeded 4 s mixtures with a
   paper-config model (random weights from seed 0) in bf16 and in f32,
   once through the kernel and once through the plain ops: 12 wavs each,
   finite and of the right length, the kernel launched 32 times per batch,
   and the two paths' outputs within the forward bars;
6. the training path: ``cli preprocess`` and ``cli train`` in process on a
   seeded two-speaker wav corpus at the paper config, bf16,
   ``--use-pallas 1``, one epoch of 4 steps at batch 8 and a cv pass:
   every step's loss finite, kernels 1 and 2 launched 32 times per step,
   kernel 1 32 times per cv batch, and the best-model package separating
   a mixture on the card (32 launches per batch);
7. one train step's loss and gradients, kernel path against plain path,
   from the same init and batch (B=4 x 4 s, two batch seeds): in f32 the
   loss within 1e-5, the global gradient within 4e-3, every multi-element
   leaf correlated >= 0.9999 (a leaf with no correlation, such as an
   all-zero gradient, fails) and the PReLU slopes within 4e-3 as one
   vector;
   in bf16 the loss within 4e-2 and the kernel path's gradient no
   further from the f32 gradient than max(8e-2, 1.25x the plain bf16
   path's);
8. timings (CUDA events, warm-ups excluded): the bf16 forward at B=8 x 4 s
   and the bf16 train step (forward + backward + optimizer) at B=8 x 4 s,
   kernel path and plain path; the kernel path's train step at
   B=24 x 4 s; each kernel against its twin per dilation.

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
DILATIONS = [2 ** i for i in range(8)]
GRAD_NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
              "dg1", "db1", "dg2", "db2")


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


def phase_kernel_vs_twin(torch, tcn):
    worst_abs = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d in DILATIONS:
            args = block_inputs(torch, dtype, d)
            kw = dict(dilation=d, causal=False, norm_type="gLN")
            got = tcn.fused_tcn_block(*args, **kw)
            torch.cuda.synchronize()
            want = tcn.fused_tcn_block_reference(*args, **kw)
            torch.cuda.synchronize()
            err = rel_l2(got, want)
            abs_err = (got.float() - want.float()).abs().max().item()
            worst_abs = max(worst_abs, abs_err)
            print(f"kernel vs twin [8,3199,256] H=512 gLN {name} d={d}: "
                  f"rel_l2 {err:.3e} (bar {TOL[name]:.0e}) "
                  f"max_abs {abs_err:.3e}", flush=True)
            check(torch.isfinite(got).all().item(), f"non-finite kernel "
                  f"output at d={d} {name}")
            check(err <= TOL[name], f"kernel disagrees with its twin at "
                  f"d={d} {name}: {err:.3e}")
    return worst_abs


def phase_bwd_vs_twin(torch, bwd):
    """Kernel 2 against its twin on all ten cotangents.

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
    cases = ([(d, False, 0.25) for d in DILATIONS]
             + [(16, True, 0.25), (4, False, -0.1)])
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
            kw = dict(dilation=d, causal=causal)
            g = torch.ones_like(x)
            got = bwd.fused_tcn_block_bwd(x, g, *w, **kw)
            torch.cuda.synchronize()
            want = bwd.fused_tcn_block_bwd_reference(x, g, *w,
                                                     norm_type="gLN", **kw)
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
                x.float(), g.float(), *[t.float() for t in w],
                norm_type="gLN", **kw)
            twin = (bwd.fused_tcn_block_bwd_reference(x, g, *w,
                                                      norm_type="gLN", **kw)
                    if dtype == torch.bfloat16 else exact)
            torch.cuda.synchronize()
            if not all(torch.isfinite(q).all().item() for q in got):
                failures.append(f"non-finite cotangent (random g) at d={d} "
                                f"{name}")
            k_err = errors(got, exact)
            held = {n: v for n, v in k_err.items()
                    if dtype == torch.float32 or n not in ("da1", "da2")}
            print(f"bwd kernel vs twin [8,3199,256] H=512 gLN {name} d={d} "
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
    print(f"bwd kernel vs twin (g=1): max_abs_err {worst_abs:.3e} at "
          f"{worst_at}", flush=True)
    check(not failures, "backward kernel disagrees with its twin: "
          + "; ".join(failures))
    return worst_abs


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


def phase_train_path(torch, tcn, bwd, work: str):
    """``cli preprocess`` + ``cli train`` at the paper config, bf16, the
    kernels forced on; then ``separate`` with the best model."""
    import numpy as np

    from convtasnet_tpu_torch import cli
    from convtasnet_tpu_torch.data.audio_io import read_wav
    from convtasnet_tpu_torch.infer.separate import separate

    n_blocks, n_cv = 32, 2
    rng = np.random.default_rng(1)
    data = os.path.join(work, "corpus")
    # 16 utterances of 4.2-6 s: 2 segments of 4 s each, 4 batches of 8
    write_corpus(data, "tr", 16, rng, 4.2, 6.0)
    write_corpus(data, "cv", n_cv, rng, 4.0, 6.0)
    json_dir = os.path.join(work, "json")
    check(cli.main(["preprocess", "--data-dir", data, "--out-dir",
                    json_dir]) == 0, "preprocess failed")
    out = os.path.join(work, "exp")
    os.environ["CONVTASNET_SEGMENT_CACHE"] = os.path.join(work, "segcache")
    tcn.fused_tcn_block.launches = 0
    bwd.fused_tcn_block_bwd.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([
        "train", "--train-dir", os.path.join(json_dir, "tr"),
        "--valid-dir", os.path.join(json_dir, "cv"), "--save-folder", out,
        "--device", "cuda", "--compute-dtype", "bfloat16",
        "--use-pallas", "1", "--epochs", "1", "--batch-size", "8",
        "--print-freq", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_n = tcn.fused_tcn_block.launches
    bwd_n = bwd.fused_tcn_block_bwd.launches
    check(rc == 0, f"cli train returned {rc}")
    with open(os.path.join(out, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "iter"]
    n_steps = len(losses)
    print(f"cli train (paper config, bf16, --use-pallas 1): {n_steps} "
          f"steps, losses {[round(x, 4) for x in losses]}, cv loss "
          f"{[r['loss'] for r in records if r.get('split') == 'valid']}, "
          f"kernel 1 launches {fwd_n}, kernel 2 launches {bwd_n}, "
          f"{wall:.1f} s wall", flush=True)
    check(n_steps == 4, f"{n_steps} train steps, expected 4")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(bwd_n == n_blocks * n_steps,
          f"kernel 2 launched {bwd_n}x, expected {n_blocks} x {n_steps}")
    check(fwd_n == n_blocks * (n_steps + n_cv),
          f"kernel 1 launched {fwd_n}x, expected {n_blocks} x "
          f"({n_steps} steps + {n_cv} cv batches)")

    pkg = os.path.join(out, "final.ckpt")
    check(os.path.exists(pkg), "no best-model package written")
    sep_dir = os.path.join(work, "sep_trained")
    tcn.fused_tcn_block.launches = 0
    n = separate(pkg, sep_dir, mix_dir=os.path.join(data, "cv", "mix"),
                 batch_size=n_cv, device="cuda")
    os.environ.pop("CONVTASNET_SEGMENT_CACHE")
    torch.cuda.synchronize()
    sep_launches = tcn.fused_tcn_block.launches
    check(n == n_cv and sep_launches == n_blocks,
          f"separate with the trained package: {n} utterances, "
          f"{sep_launches} launches")
    mix_dir = os.path.join(data, "cv", "mix")
    for name in sorted(f for f in os.listdir(mix_dir) if f.endswith(".wav")):
        T = read_wav(os.path.join(mix_dir, name))[0].shape[0]
        for c in (1, 2):
            y, sr = read_wav(os.path.join(
                sep_dir, name.replace(".wav", f"_s{c}.wav")))
            check(sr == SAMPLE_RATE and y.shape == (T,)
                  and np.isfinite(y).all(), f"bad separated {name} s{c}")
    print(f"separate with the trained package: {n} utterances, kernel 1 "
          f"launches {sep_launches} (1 batch)", flush=True)
    return fwd_n, bwd_n


def train_batch(torch, M: int, seed: int):
    """A seeded [M, 4 s] training batch on the card."""
    T = SECONDS * SAMPLE_RATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(M, T, generator=g, device="cuda"),
            torch.full((M,), T, dtype=torch.int32, device="cuda"),
            torch.randn(M, 2, T, generator=g, device="cuda"),
            torch.ones(M, device="cuda"))


def phase_step_compare(torch):
    """Loss and gradients of one train step, kernel path vs plain path,
    from the same init and batch, for two batch seeds.

    At random init the paper model's gradient is ill-conditioned: in f32
    the plain path against itself with its sums reordered (gradients
    accumulated over 2-row chunks) moves by ~1.3e-3 globally and by 10% on
    the smallest scalar PReLU-slope gradients, and in bf16 either path is
    ~0.2 from the f32 gradient. So in f32 the loss, the global gradient,
    the correlation of every multi-element leaf (the JAX whole-model
    test's criterion) and the slopes as one vector are held; in bf16 the
    loss, and the kernel path's distance from the f32 gradient against
    the plain bf16 path's own. Every reading is printed before the phase
    fails."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import init_params
    from convtasnet_tpu_torch.train import train_step as ts

    failures = []
    for seed in (11, 12):
        batch = train_batch(torch, 4, seed)
        for dtype in ("float32", "bfloat16"):
            cfg = ConvTasNetConfig(compute_dtype=dtype)
            sd = init_params(cfg, torch.Generator().manual_seed(0))
            res = {}
            for path, flag, chunk in (("kernel", True, 0),
                                      ("plain", False, 0),
                                      ("plain_c2", False, 2)):
                state = ts.create_train_state(cfg, SolverConfig(),
                                              device="cuda", use_pallas=flag,
                                              state_dict=sd)
                loss = float(ts._loss_and_grads(state.model, batch, chunk))
                res[path] = (loss, {n: p.grad.detach().float().clone()
                                    for n, p in
                                    state.model.named_parameters()})
                del state
            (lk, gk), (lp, gp), (_, gc) = (res[k] for k in
                                           ("kernel", "plain", "plain_c2"))
            flat = {k: torch.cat([g.reshape(-1) for g in v.values()])
                    for k, v in (("kernel", gk), ("plain", gp), ("c2", gc))}
            if not all(torch.isfinite(v).all().item() for v in flat.values()):
                failures.append(f"non-finite gradients ({dtype}, seed {seed})")
            loss_rel = abs(lk - lp) / abs(lp)
            global_err = rel_l2(flat["kernel"], flat["plain"])
            head = (f"train step {dtype} B=4x{SECONDS}s seed {seed} kernel "
                    f"vs plain: loss {lk:.6f} vs {lp:.6f} (rel "
                    f"{loss_rel:.3e}), global gradient rel_l2 "
                    f"{global_err:.3e} (plain vs itself reordered "
                    f"{rel_l2(flat['c2'], flat['plain']):.3e})")
            at = f"{dtype} seed {seed}"
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
                                   torch.stack([gp[n] for n in slopes]))
                print(f"{head}; lowest leaf correlation {low} "
                      f"{corr[low]:.7f}; the {len(slopes)} slopes as one "
                      f"vector rel_l2 {slope_err:.3e}", flush=True)
                if loss_rel > 1e-5:
                    failures.append(f"{at} loss off by {loss_rel:.3e}")
                if global_err > BWD_TOL[dtype]:
                    failures.append(f"{at} global gradient off by "
                                    f"{global_err:.3e}")
                if corr[low] < 0.9999:
                    failures.append(f"{at} gradient leaf {low} correlation "
                                    f"{corr[low]:.7f}")
                if slope_err > BWD_TOL[dtype]:
                    failures.append(f"{at} slope gradients off by "
                                    f"{slope_err:.3e}")
            else:
                k_f32 = rel_l2(flat["kernel"], f32_grads)
                p_f32 = rel_l2(flat["plain"], f32_grads)
                bar = max(BWD_TOL[dtype], 1.25 * p_f32)
                print(f"{head}; from the f32 gradient: kernel path "
                      f"{k_f32:.3e}, plain path {p_f32:.3e} (bar {bar:.3e})",
                      flush=True)
                if loss_rel > 4e-2:
                    failures.append(f"{at} loss off by {loss_rel:.3e}")
                if k_f32 > bar:
                    failures.append(f"{at} kernel-path gradient {k_f32:.3e} "
                                    f"from the f32 one, plain path "
                                    f"{p_f32:.3e}")
    check(not failures, "train step, kernel vs plain: " + "; ".join(failures))


def phase_main_path(torch, tcn, work: str):
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
        pkg = os.path.join(work, f"paper_{dtype}.pt")
        save_inference_package(
            pkg, cfg, init_params(cfg, torch.Generator().manual_seed(0)))
        outs = {}
        for path, use_kernel in (("kernel", True), ("plain", False)):
            out_dir = os.path.join(work, f"out_{dtype}_{path}")
            tcn.fused_tcn_block.launches = 0
            n = separate(pkg, out_dir, mix_dir=mix_dir, batch_size=batch_size,
                         use_pallas=None if use_kernel else False,
                         device="cuda")
            torch.cuda.synchronize()
            count = tcn.fused_tcn_block.launches
            if use_kernel:
                check(count == cfg.num_repeats * cfg.num_blocks * n_batches,
                      f"{count} kernel launches, expected "
                      f"{cfg.num_repeats * cfg.num_blocks} x {n_batches}")
            else:
                check(count == 0, f"plain path launched the kernel {count}x")
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
                  f"wavs of {T} samples, kernel launches {count} "
                  f"({n_batches} batch)", flush=True)
        err = rel_l2(outs["kernel"], outs["plain"])
        print(f"separate {dtype}: kernel path vs plain path rel_l2 "
              f"{err:.3e} (bar {TOL[dtype]:.0e})", flush=True)
        check(err <= TOL[dtype], f"separated outputs disagree ({dtype}): "
              f"{err:.3e}")


def phase_timings(torch, tcn, bwd, card: str):
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    cfg = ConvTasNetConfig(compute_dtype="bfloat16")
    M = 8
    mix = torch.randn(M, SECONDS * SAMPLE_RATE,
                      generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda")
    models = {name: ConvTasNet(cfg, use_pallas=flag, device="cuda").eval()
              for name, flag in (("kernel", True), ("plain", False))}
    runs = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name].append(time_ms(torch, lambda: models[name](mix), 10))
    fwd = {k: statistics.median(v) for k, v in runs.items()}
    audio_s = M * SECONDS
    for name in ("kernel", "plain"):
        print(f"timing [{card}] forward B={M}x{SECONDS}s bf16 {name} path: "
              f"{fwd[name]:.3f} ms, {audio_s / (fwd[name] / 1e3):.1f}x "
              f"realtime (runs {[round(r, 3) for r in runs[name]]})",
              flush=True)

    del models
    phase_train_timings(torch, cfg, card)

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
    return [statistics.mean(v[i] for v in per_block.values())
            for i in range(4)]


def phase_train_timings(torch, cfg, card: str):
    """The bf16 train step (forward + backward + optimizer) at B=8 x 4 s,
    kernel path vs plain path in turns, and the kernel path at B=24."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    step = ts.make_train_step()

    def step_ms(flag, M, iters):
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=flag)
        batch = train_batch(torch, M, 21)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: step(state, batch), iters)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = {"kernel": [], "plain": []}
    mem = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms, mem[name] = step_ms(name == "kernel", 8, 10)
        runs[name].append(ms)
    for name in ("kernel", "plain"):
        med = statistics.median(runs[name])
        print(f"timing [{card}] train step B=8x{SECONDS}s bf16 {name} path: "
              f"{med:.3f} ms (runs {[round(r, 3) for r in runs[name]]}), "
              f"peak memory {mem[name]:.2f} GiB", flush=True)
    ms24, mem24 = step_ms(True, 24, 5)
    print(f"timing [{card}] train step B=24x{SECONDS}s bf16 kernel path: "
          f"{ms24:.3f} ms, peak memory {mem24:.2f} GiB", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from convtasnet_tpu_torch.ops.cuda import build
    from convtasnet_tpu_torch.ops.cuda import tcn_block as tcn
    from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as bwd

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

    max_abs = phase_kernel_vs_twin(torch, tcn)
    max_abs_bwd = phase_bwd_vs_twin(torch, bwd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_main_path(torch, tcn, work)
        fwd_launches, bwd_launches = phase_train_path(torch, tcn, bwd, work)
    phase_step_compare(torch)
    k_ms, p_ms, kb_ms, pb_ms = phase_timings(torch, tcn, bwd, card)

    print(json.dumps({"kernels": [{
        "name": "tcn_block",
        "route": "cuda",
        "source": "convtasnet_tpu_torch/csrc/tcn_block.cu",
        "replaces": "convtasnet_tpu/ops/pallas/tcn_block.py:92",
        "launches": fwd_launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "tcn_block_bwd",
        "route": "cuda",
        "source": "convtasnet_tpu_torch/csrc/tcn_block_bwd.cu",
        "replaces": "convtasnet_tpu/ops/pallas/tcn_block_bwd.py:74",
        "launches": bwd_launches,
        "max_abs_err": max_abs_bwd,
        "ms": kb_ms,
        "plain_ms": pb_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
