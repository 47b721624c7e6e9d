"""Mixture-corpus generation: the Python replacement for the reference's
MATLAB pipeline.

The port's own copy of ``convtasnet_tpu/tools/mixture.py`` (numpy, the same
names; ``tests/test_torch_tools.py`` holds the wavs it writes to the JAX
module's, sample for sample).

Capability parity with ``tools/matlab-code/create_wav_2speakers.m`` (and the
fork's custom-corpus helpers ``tools/create_txt_file_like_wsj0.py``):

- ``make_pair_list``: random speaker pairing with SNR offsets drawn from
  ±[0.01, 2.5] dB, emitting wsj0-style mixture list rows
  ``path1 snr1 path2 snr2 [...]`` (generalized to C speakers).
- ``create_mixtures``: for each row — load sources, resample to the target
  rate, P.56 loudness-normalize (``activlev .. 'n'``), apply the per-source
  SNR gains, truncate to the shortest ('min') or zero-pad to the longest
  ('max'), sum, rescale the whole group so the peak magnitude is 0.9, and
  write ``s1..sC`` + ``mix`` wavs plus the per-utterance scaling factors
  (the MATLAB saved ``scaling.mat``; we save ``scaling.npz``).

Output tree matches what the manifest layer expects:
``out_root/{tr,cv,tt}/{mix,s1..sC}/<name>.wav``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from convtasnet_tpu_torch.data.audio_io import read_wav, resample, write_wav
from convtasnet_tpu_torch.tools.activlev import normalize_active


@dataclass
class MixRow:
    paths: Tuple[str, ...]
    snrs: Tuple[float, ...]

    @property
    def name(self) -> str:
        parts = []
        for p, s in zip(self.paths, self.snrs):
            stem = os.path.splitext(os.path.basename(p))[0]
            parts.append(f"{stem}_{s:g}")
        return "_".join(parts)


def make_pair_list(
    wav_files_by_speaker: dict,
    num_mixtures: int,
    num_speakers: int = 2,
    snr_range: Tuple[float, float] = (0.01, 2.5),
    seed: int = 0,
) -> List[MixRow]:
    """Random cross-speaker pairing (parity: ``create_txt_file_like_wsj0.py``:
    different speakers per mixture, SNR magnitude uniform in ``snr_range``
    applied ± symmetrically)."""
    rng = np.random.default_rng(seed)
    speakers = sorted(wav_files_by_speaker)
    assert len(speakers) >= num_speakers, "not enough speakers"
    rows = []
    for _ in range(num_mixtures):
        spk = rng.choice(len(speakers), size=num_speakers, replace=False)
        paths = tuple(
            str(rng.choice(wav_files_by_speaker[speakers[s]])) for s in spk
        )
        mag = rng.uniform(*snr_range)
        snrs = [round(float(mag), 6), round(float(-mag), 6)]
        while len(snrs) < num_speakers:
            snrs.append(round(float(rng.uniform(-snr_range[1], snr_range[1])), 6))
        rows.append(MixRow(paths, tuple(snrs[:num_speakers])))
    return rows


def write_pair_list(rows: Sequence[MixRow], path: str) -> None:
    with open(path, "w") as f:
        for r in rows:
            cols = []
            for p, s in zip(r.paths, r.snrs):
                cols += [p, f"{s:.6f}"]
            f.write(" ".join(cols) + "\n")


def read_pair_list(path: str) -> List[MixRow]:
    rows = []
    with open(path) as f:
        for line in f:
            cols = line.split()
            if not cols:
                continue
            paths = tuple(cols[0::2])
            snrs = tuple(float(s) for s in cols[1::2])
            rows.append(MixRow(paths, snrs))
    return rows


def _make_dirs(out_dir: str, C: int) -> None:
    for p in [f"s{i + 1}" for i in range(C)] + ["mix"]:
        os.makedirs(os.path.join(out_dir, p), exist_ok=True)


def _gained_sources(raw, snrs, sample_rate: int) -> List[np.ndarray]:
    """Resample + P.56-normalize each source, apply its ±SNR gain."""
    srcs = []
    for (x, x_sr), snr in zip(raw, snrs):
        if x_sr != sample_rate:
            x = resample(x, x_sr, sample_rate)
        x, _ = normalize_active(x, sample_rate)
        srcs.append(10.0 ** (snr / 20.0) * x)
    return srcs


def _cut_mix_scale(srcs, mode: str, peak: float):
    """min-cut / max-pad to a common length, sum, joint-peak rescan.

    Returns (cut_sources, mix, scale) with scale = peak / max(|mix|, |s_i|)
    — the MATLAB generator's 0.9-peak rescue (create_wav_2speakers.m:139-152).
    """
    if mode == "min":
        T = min(len(s) for s in srcs)
        cut = [s[:T] for s in srcs]
    else:
        T = max(len(s) for s in srcs)
        cut = [np.pad(s, (0, T - len(s))) for s in srcs]
    mix = np.sum(cut, axis=0)
    max_amp = max(float(np.max(np.abs(mix))),
                  *[float(np.max(np.abs(s))) for s in cut])
    scale = peak / max_amp if max_amp > 0 else 1.0
    return cut, mix, scale


def _write_row(out_dir: str, name: str, cut, mix, scale: float,
               sample_rate: int) -> None:
    for c, s in enumerate(cut):
        write_wav(os.path.join(out_dir, f"s{c + 1}", name + ".wav"),
                  scale * s, sample_rate)
    write_wav(os.path.join(out_dir, "mix", name + ".wav"),
              scale * mix, sample_rate)


def create_mixtures(
    rows: Sequence[MixRow],
    out_dir: str,
    sample_rate: int = 8000,
    mode: str = "min",
    source_root: str = "",
    peak: float = 0.9,
) -> List[str]:
    """Generate the mixture corpus for one split. Returns mixture names."""
    assert mode in ("min", "max")
    C = len(rows[0].paths) if rows else 2
    _make_dirs(out_dir, C)

    names = []
    scalings = []
    for row in rows:
        raw = [read_wav(os.path.join(source_root, p)) for p in row.paths]
        srcs = _gained_sources(raw, row.snrs, sample_rate)
        cut, mix, scale = _cut_mix_scale(srcs, mode, peak)
        names.append(row.name)
        scalings.append(scale)
        _write_row(out_dir, row.name, cut, mix, scale, sample_rate)
    np.savez(os.path.join(out_dir, "scaling.npz"),
             names=np.array(names), scaling=np.array(scalings))
    return names


def create_mixtures_multi(
    rows: Sequence[MixRow],
    out_root: str,
    sample_rates: Sequence[int] = (8000, 16000),
    modes: Sequence[str] = ("min", "max"),
    source_root: str = "",
    peak: float = 0.9,
    split: str = "",
) -> List[str]:
    """All (rate, mode) variants in ONE pass over the sources.

    Parity with the MATLAB generator, which writes ``wav8k/min``,
    ``wav8k/max``, ``wav16k/min`` and ``wav16k/max`` (plus per-variant
    scaling files) from a single read of each source pair
    (``create_wav_2speakers.m:157-181``). Each source is read once at its
    native rate, then resampled + P.56-normalized per target rate; min/max
    share those normalized sources. Output tree:
    ``out_root/wav{R}k/{mode}[/{split}]/{s1..sC,mix}/<name>.wav`` — with
    ``split`` (tr/cv/tt) this is exactly the MATLAB generator's layout.
    """
    for mode in modes:
        assert mode in ("min", "max"), mode
    C = len(rows[0].paths) if rows else 2
    variants = [(sr, mode) for sr in sample_rates for mode in modes]
    dirs = {}
    for sr, mode in variants:
        d = os.path.join(out_root, f"wav{sr // 1000}k", mode, split)
        dirs[(sr, mode)] = d
        _make_dirs(d, C)

    names = []
    scalings = {v: [] for v in variants}
    for row in rows:
        raw = [read_wav(os.path.join(source_root, p)) for p in row.paths]
        names.append(row.name)
        for sr in sample_rates:
            srcs = _gained_sources(raw, row.snrs, sr)
            for mode in modes:
                cut, mix, scale = _cut_mix_scale(srcs, mode, peak)
                scalings[(sr, mode)].append(scale)
                _write_row(dirs[(sr, mode)], row.name, cut, mix, scale, sr)
    for v, d in dirs.items():
        np.savez(os.path.join(d, "scaling.npz"),
                 names=np.array(names), scaling=np.array(scalings[v]))
    return names


def flac_to_wav(flac_dir: str, wav_dir: str) -> int:
    """flac -> wav conversion (parity: ``tools/flac_to_wav.py``).

    Requires the ``ffmpeg`` binary (the reference used ffmpeg-python); if it
    is unavailable this raises with a clear message — this image has no flac
    decoder.
    """
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found: flac decoding is unavailable in this "
            "environment; provide wav inputs instead")
    os.makedirs(wav_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(flac_dir)):
        if not name.endswith(".flac"):
            continue
        out = os.path.join(wav_dir, os.path.splitext(name)[0] + ".wav")
        subprocess.run(
            ["ffmpeg", "-loglevel", "error", "-y", "-i",
             os.path.join(flac_dir, name), out],
            check=True)
        n += 1
    return n
