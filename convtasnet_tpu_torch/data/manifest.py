"""Manifest construction: wav directory -> JSON list of (path, num_samples).

Counterpart of ``convtasnet_tpu/data/manifest.py``: sample counts come
from the WAV header, scaled by the resampling ratio when the target rate
differs; ``build_manifests`` covers a whole
``{tr,cv,tt}/{mix,s1..sC}`` tree.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Sequence, Tuple

from convtasnet_tpu_torch.data.audio_io import (
    wav_duration_samples,
    wav_sample_rate,
)


def _resampled_len(n: int, native_sr: int, target_sr: int) -> int:
    """Output length of polyphase resampling (as scipy.resample_poly)."""
    if native_sr == target_sr:
        return n
    g = math.gcd(native_sr, target_sr)
    up, down = target_sr // g, native_sr // g
    return int(math.ceil(n * up / down))


def build_manifest(wav_dir: str, out_dir: str, part: str,
                   sample_rate: int = 8000) -> str:
    """Scan ``wav_dir`` for .wav files and write ``out_dir/<part>.json``;
    returns the json path."""
    infos: List[Tuple[str, int]] = []
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav"):
            continue
        path = os.path.abspath(os.path.join(wav_dir, name))
        n = wav_duration_samples(path)
        infos.append((path, _resampled_len(n, wav_sample_rate(path),
                                           sample_rate)))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, part + ".json")
    with open(out_path, "w") as f:
        json.dump(infos, f, indent=4)
    return out_path


def build_manifests(
    data_dir: str,
    out_dir: str,
    sample_rate: int = 8000,
    splits: Sequence[str] = ("tr", "cv", "tt"),
    num_speakers: int = 2,
    parts: Optional[Sequence[str]] = None,
) -> None:
    """Write ``out_dir/<split>/<part>.json`` for every
    ``data_dir/<split>/<part>/`` wav directory that exists, parts
    ``mix, s1..sC`` unless given."""
    if parts is None:
        parts = ["mix"] + [f"s{i + 1}" for i in range(num_speakers)]
    for split in splits:
        for part in parts:
            wav_dir = os.path.join(data_dir, split, part)
            if os.path.isdir(wav_dir):
                build_manifest(wav_dir, os.path.join(out_dir, split), part,
                               sample_rate)
