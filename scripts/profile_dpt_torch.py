#!/usr/bin/env python3
"""Device time by CUDA kernel for the PyTorch port's DPT forward, on one GPU.

    PYTHONPATH=. python3 scripts/profile_dpt_torch.py [--batch 8] [--seconds 4]

Runs the dual-path quality default (``--separator dpt``, bf16, random
weights from seed 0) at [batch, seconds * 8 kHz] through the hand-written
kernels, warms up, then traces ``--iters`` forwards with
``torch.profiler`` and prints each CUDA kernel's device time per forward
and its launches per forward, the summed device time, the wall time per
forward measured with CUDA events outside the trace, and the card
(``nvidia-smi`` name and power limit). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

    if not torch.cuda.is_available():
        print("profile_dpt_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = ConvTasNetConfig(separator="dpt", compute_dtype="bfloat16")
    model = ConvTasNet(cfg, device="cuda").eval()
    mix = torch.randn(a.batch, int(a.seconds * cfg.sample_rate),
                      device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    with torch.inference_mode():
        for _ in range(3):
            model(mix)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.iters):
            model(mix)
        end.record()
        end.synchronize()
        wall_ms = start.elapsed_time(end) / a.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(a.iters):
                model(mix)
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / a.iters
    print(card)
    print(f"dpt forward [{a.batch} x {a.seconds} s] bf16 kernel path: "
          f"{wall_ms:.3f} ms per forward (CUDA events), device kernels "
          f"{total / 1e3:.3f} ms per forward (profiler)")
    for e in rows:
        us = e.self_device_time_total / a.iters
        print(f"{us:10.1f} us {e.count / a.iters:6.1f} launches  "
              f"{100 * us / total:5.1f}%  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
