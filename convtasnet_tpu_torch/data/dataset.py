"""Mixture batches for separation.

Counterpart of ``EvalDataset`` in ``convtasnet_tpu/data/dataset.py``:
length-sorted (longest first) batches of ``batch_size`` mixtures, with the
manifest built from a directory when one is given.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from convtasnet_tpu_torch.data.audio_io import read_wav
from convtasnet_tpu_torch.data.manifest import build_manifest


class EvalDataset:
    """Batches of ``batch_size`` length-sorted mixtures from ``mix_dir``
    (manifest built there) or from the manifest ``mix_json``."""

    def __init__(self, mix_dir: Optional[str] = None,
                 mix_json: Optional[str] = None, batch_size: int = 1,
                 sample_rate: int = 8000):
        if mix_dir is None and mix_json is None:
            raise ValueError("EvalDataset needs mix_dir or mix_json")
        if mix_dir is not None:
            mix_json = build_manifest(mix_dir, mix_dir, "mix", sample_rate)
        with open(mix_json) as f:
            infos = json.load(f)
        infos.sort(key=lambda r: int(r[1]), reverse=True)
        self.sample_rate = sample_rate
        self.plan = [infos[i: i + batch_size]
                     for i in range(0, len(infos), batch_size)]

    def __len__(self) -> int:
        return len(self.plan)

    def load_batch(self, index: int, pad_to_multiple: int = 1):
        """-> (mixture [B, T] float32, lengths [B] int32, filenames); T is
        the longest length rounded up to ``pad_to_multiple``."""
        rows = self.plan[index]
        waves = [read_wav(r[0], self.sample_rate)[0] for r in rows]
        maxT = max(w.shape[-1] for w in waves)
        maxT = -(-maxT // pad_to_multiple) * pad_to_multiple
        mixture = np.zeros((len(waves), maxT), np.float32)
        lengths = np.zeros((len(waves),), np.int32)
        for b, w in enumerate(waves):
            mixture[b, : w.shape[-1]] = w
            lengths[b] = w.shape[-1]
        return mixture, lengths, [r[0] for r in rows]
