#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each raising on failure (so the script exits nonzero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the TCN-block CUDA kernel from ``convtasnet_tpu_torch/csrc``;
3. the kernel against its plain PyTorch twin at the serving shape
   ([8, 3199, 256], H=512), every dilation 1..128, gLN, bf16 and f32, at the
   relative-L2 bars of the JAX package's Pallas probe gate (4e-2 / 2e-3);
4. the main path: ``separate`` on four seeded 4 s mixtures with a
   paper-config model (random weights from seed 0) in bf16 and in f32,
   once through the kernel and once through the plain ops: 12 wavs each,
   finite and of the right length, the kernel launched 32 times per batch,
   and the two paths' outputs within the same bars;
5. timings: the bf16 forward at B=8 x 4 s, kernel path and plain path, and
   the per-block kernel against the plain block at each dilation.

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SAMPLE_RATE = 8000
SECONDS = 4
TOL = {"bfloat16": 4e-2, "float32": 2e-3}   # tcn_block.py _numerics_tol
DILATIONS = [2 ** i for i in range(8)]


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
                 H=512, P=3):
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
    a2 = torch.tensor(0.25, device="cuda")
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
    launches = 0
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
                if dtype == "bfloat16":
                    launches = count
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
    return launches


def phase_timings(torch, tcn, card: str):
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

    per_block = {}
    for d in DILATIONS:
        args = block_inputs(torch, torch.bfloat16, d)
        kw = dict(dilation=d, causal=False, norm_type="gLN")
        k_ms = time_ms(torch, lambda: tcn.fused_tcn_block(*args, **kw), 20)
        p_ms = time_ms(torch,
                       lambda: tcn.fused_tcn_block_reference(*args, **kw), 20)
        per_block[d] = (k_ms, p_ms)
        print(f"timing [{card}] block [8,3199,256] H=512 gLN bf16 d={d}: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
    k_mean = statistics.mean(v[0] for v in per_block.values())
    p_mean = statistics.mean(v[1] for v in per_block.values())
    return k_mean, p_mean


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from convtasnet_tpu_torch.ops.cuda import build
    from convtasnet_tpu_torch.ops.cuda import tcn_block as tcn

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        launches = phase_main_path(torch, tcn, work)
    k_ms, p_ms = phase_timings(torch, tcn, card)

    print(json.dumps({"kernels": [{
        "name": "tcn_block",
        "route": "cuda",
        "source": "convtasnet_tpu_torch/csrc/tcn_block.cu",
        "replaces": "convtasnet_tpu/ops/pallas/tcn_block.py:92",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
