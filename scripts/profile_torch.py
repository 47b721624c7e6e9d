#!/usr/bin/env python3
"""Device time by CUDA kernel for the PyTorch port's TCN or DPT forward or
train step, on one GPU.

    PYTHONPATH=. python3 scripts/profile_torch.py {tcn,dpt} [forward|train] \\
        [--norm gLN|cLN] [--pairs] [--batch 8] [--seconds 4] [--iters 10]

Runs a model in bf16 with random weights from seed 0 at [batch, seconds *
8 kHz] through the hand-written kernels: ``tcn`` the paper config (gLN;
``--norm cLN`` its causal cLN variant) with block pairs off, the default
(``CONVTASNET_PAIR_FUSION=0``), or with ``--pairs`` on (blocks (x, x+1)
through the pair kernels: the forward's pairs through B4, a gLN step's
through B4 and B5), ``dpt`` the dual-path quality default
(``--separator dpt``). ``forward`` (the default) a forward under inference mode,
``train`` one train step (forward, uPIT loss, backward, clip, Adam) on a
seeded batch. It warms up, then traces ``--iters`` calls with
``torch.profiler`` and prints each CUDA kernel's device time per call and
its launches per call, the summed device time, the wall time per call
measured with CUDA events outside the trace (the device's idle share is
1 - device time / wall time), and the card (``nvidia-smi`` name and power
limit). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys


def _forward(torch, cfg, batch: int, T: int):
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    model = ConvTasNet(cfg, device="cuda").eval()
    mix = torch.randn(batch, T, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    return lambda: model(mix), torch.inference_mode()


def _train(torch, cfg, batch: int, T: int):
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                  use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    data = (torch.randn(batch, T, generator=gen, device="cuda"),
            torch.full((batch,), T, dtype=torch.int32, device="cuda"),
            torch.randn(batch, 2, T, generator=gen, device="cuda"),
            torch.ones(batch, device="cuda"))
    step = ts.make_train_step()
    return lambda: step(state, data), contextlib.nullcontext()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=["tcn", "dpt"])
    ap.add_argument("mode", nargs="?", default="forward",
                    choices=["forward", "train"])
    ap.add_argument("--norm", default="gLN", choices=["gLN", "cLN"],
                    help="the TCN's norm; cLN runs it causal")
    ap.add_argument("--pairs", action="store_true",
                    help="run the TCN's blocks as pairs "
                         "(CONVTASNET_PAIR_FUSION=1)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from convtasnet_tpu_torch import ConvTasNetConfig

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from convtasnet_tpu_torch.models.conv_tasnet import PAIR_ENV

    os.environ[PAIR_ENV] = "1" if a.pairs else "0"
    if a.model == "dpt":
        cfg = ConvTasNetConfig(separator="dpt", compute_dtype="bfloat16")
        label = "dpt"
    else:
        cfg = ConvTasNetConfig(norm_type=a.norm, causal=a.norm == "cLN",
                               compute_dtype="bfloat16")
        label = f"tcn {a.norm}" + (" pairs" if a.pairs else "")
    build = _forward if a.mode == "forward" else _train
    call, ctx = build(torch, cfg, a.batch, int(a.seconds * cfg.sample_rate))
    with ctx:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.iters):
            call()
        end.record()
        end.synchronize()
        wall_ms = start.elapsed_time(end) / a.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(a.iters):
                call()
            torch.cuda.synchronize()
    # the device's own work only: a user annotation's span (such as
    # "Optimizer.step#Adam.step") also reports device time, and is skipped
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and "#" not in e.key]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / a.iters
    unit = "forward" if a.mode == "forward" else "step"
    print(card)
    print(f"{label} {a.mode} [{a.batch} x {a.seconds} s] bf16 kernel path: "
          f"{wall_ms:.3f} ms per {unit} (CUDA events), device kernels "
          f"{total / 1e3:.3f} ms per {unit} (profiler), idle share "
          f"{1 - total / 1e3 / wall_ms:.3f}")
    for e in rows[:60]:
        us = e.self_device_time_total / a.iters
        print(f"{us:10.1f} us {e.count / a.iters:6.1f} launches  "
              f"{100 * us / total:5.1f}%  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
