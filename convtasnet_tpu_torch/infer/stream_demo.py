"""Real-time streaming separation demo with serving-latency statistics.

Counterpart of ``convtasnet_tpu/infer/stream_demo.py``: one wav streams
through the causal separator (``models/streaming.py``) the way a serving
process would run it. Fixed-size chunks arrive one at a time, each
``process`` call must return before the next chunk lands, and the budget
per chunk is the chunk's own duration. Each timed call includes the copy
of the chunk to the device and of its output back to the host
(``out.cpu()``), as a live audio callback would need.

Reports per-chunk wall latency (p50/p95/p99/max), the real-time factor and
whether the run met its deadline (p99 < chunk duration); optionally writes
the separated streams. ``python -m convtasnet_tpu_torch.cli stream-demo``
runs it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
from convtasnet_tpu_torch.infer.separate import resolve_device
from convtasnet_tpu_torch.models.streaming import StreamingSeparator
from convtasnet_tpu_torch.train.checkpoint import load_params_for_inference


def stream_demo(
    model_path: str,
    wav_path: str,
    chunk_ms: float = 8.0,
    out_dir: Optional[str] = None,
    realtime: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """Stream one wav through the causal separator chunk by chunk.

    ``model_path``: a causal (cLN or BN) inference package or checkpoint.
    ``chunk_ms`` is rounded down to whole encoder hops. ``out_dir``: write
    ``<stem>_s{c}.wav`` there. ``realtime``: sleep so chunks arrive at the
    wall-clock rate. ``device``: where the separator runs (cuda raises when
    CUDA is absent).

    Returns ``{"chunk_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms", "rtf",
    "deadline_met", "latency_ms"}``; ``latency_ms`` is the algorithmic
    latency (one encoder window) plus the chunk duration.
    """
    device = resolve_device(device)
    cfg, state_dict = load_params_for_inference(model_path)
    x, sr = read_wav(wav_path, sample_rate=cfg.sample_rate)
    hop = cfg.stride
    chunk = max(hop, int(chunk_ms * sr / 1000.0) // hop * hop)
    chunk_s = chunk / sr
    T = len(x)
    Tp = ((T + chunk - 1) // chunk) * chunk
    buf = np.zeros((1, Tp), np.float32)
    buf[0, :T] = x

    sep = StreamingSeparator(cfg, state_dict, batch_size=1, device=device)
    # warm up outside the timed region (a server would too)
    sep.process(torch.zeros((1, chunk))).cpu()
    sep.reset()

    outs, lat = [], []
    t_start = time.perf_counter()
    for s in range(0, Tp, chunk):
        if realtime:
            wait = t_start + s / sr - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        t0 = time.perf_counter()
        out = sep.process(torch.from_numpy(buf[:, s:s + chunk])).cpu()
        lat.append(time.perf_counter() - t0)
        outs.append(out.numpy())
    outs.append(sep.flush().cpu().numpy())
    est = np.concatenate(outs, axis=-1)[0, :, :T]

    lat_ms = np.sort(np.array(lat) * 1e3)
    stats = {
        "chunk_ms": round(1000 * chunk_s, 3),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 3),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
        "max_ms": round(float(lat_ms[-1]), 3),
        "rtf": round((T / sr) / max(float(np.sum(lat)), 1e-9), 2),
        "deadline_met": bool(np.percentile(lat_ms, 99) < 1000 * chunk_s),
        "latency_ms": round(1000 * (cfg.kernel_size / sr + chunk_s), 3),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(wav_path))[0]
        for c in range(est.shape[0]):
            write_wav(os.path.join(out_dir, f"{stem}_s{c + 1}.wav"), est[c],
                      sr)
    return stats

