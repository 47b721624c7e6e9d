"""Training logs and profiling.

Counterpart of ``convtasnet_tpu/utils/metrics.py``: stdout prints (epoch
summaries, per-iteration loss, running average and ms per batch), a JSONL
history (``<save_folder>/history.jsonl``) that a plotting front end can
tail, and ``StepProfiler``, which traces a window of training steps with
``torch.profiler`` (the card's kernels too when CUDA is present) and writes
a Chrome trace into the profile directory.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.history_path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.history_path = os.path.join(log_dir, "history.jsonl")

    def print(self, msg: str) -> None:
        print(msg, flush=True)

    def _append(self, record: Dict[str, Any]) -> None:
        if self.history_path:
            with open(self.history_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def log_iter(self, epoch: int, it: int, metrics: Dict[str, float]) -> None:
        self.print(
            "Epoch {0} | Iter {1} | Average Loss {2:.3f} | Current Loss "
            "{3:.6f} | {4:.1f} ms/batch".format(
                epoch + 1, it + 1, metrics.get("avg_loss", float("nan")),
                metrics.get("loss", float("nan")),
                metrics.get("ms_per_batch", float("nan"))))
        self._append({"kind": "iter", "epoch": epoch, "iter": it,
                      "t": time.time(), **metrics})

    def log_epoch(self, epoch: int, split: str, loss: float,
                  seconds: float) -> None:
        name = "Train" if split == "train" else "Valid"
        self.print("-" * 85)
        self.print(f"{name} Summary | End of Epoch {epoch + 1} | "
                   f"Time {seconds:.2f}s | {name} Loss {loss:.3f}")
        self.print("-" * 85)
        self._append({"kind": "epoch", "epoch": epoch, "split": split,
                      "loss": loss, "seconds": seconds, "t": time.time()})


class StepProfiler:
    """Trace the steps [start_step, start_step + num_steps): call
    ``step(i)`` before step i runs; ``close()`` ends an open trace (safe to
    call always). Step 0, the warm-up step that builds the kernels, is
    left out by default."""

    def __init__(self, log_dir: str, start_step: int = 1,
                 num_steps: int = 10, enabled: bool = True):
        self.log_dir = log_dir
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self.enabled = enabled and bool(log_dir)
        self._prof = None

    def step(self, i: int) -> None:
        if not self.enabled:
            return
        if self._prof is None and self.start_step <= i < self.end_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and i >= self.end_step:
            self.close()
            self.enabled = False  # one window per run

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))
        self._prof = None
