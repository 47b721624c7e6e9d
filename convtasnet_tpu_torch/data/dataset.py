"""Training batches and mixture batches.

Counterpart of ``convtasnet_tpu/data/dataset.py``:

- ``SeparationDataset``: the reference loader's static minibatch plan,
  built once from the manifests. Utterances are sorted longest first;
  each one of at least ``segment`` seconds gives ceil(len/segment)
  segments, the tail re-anchored at ``[-segment_len:]``; a batch holds at
  most ``batch_size`` segments and an utterance longer than a whole batch
  gets one of its own capped at ``batch_size``; shorter utterances are
  dropped; ``max_hours`` caps the subset. Every training batch is a static
  ``[batch_size, segment_len]`` shape: a partial batch is padded with
  zero-weight rows, which add nothing to the loss. With ``segment < 0``
  (cv/tt) rows are whole utterances, ``batch_size`` per batch, those
  longer than ``cv_maxlen`` skipped one at a time ("fixed") or with their
  whole window ("reference", the reference's own rule).
- ``EvalDataset``: length-sorted (longest first) batches of
  ``batch_size`` mixtures for separation, with the manifest built from a
  directory when one is given.

Decoding is the numpy ``read_wav``; the JAX package's native C++ decoder
is not ported, and it falls back to the same codec itself.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from convtasnet_tpu_torch.data.audio_io import read_wav
from convtasnet_tpu_torch.data.manifest import build_manifest


def load_waves(paths: Sequence[str], sample_rate: int) -> List[np.ndarray]:
    """Decode one utterance's wavs (mix, s1..sC) to float32 mono at
    ``sample_rate``."""
    return [read_wav(p, sample_rate)[0] for p in paths]


@dataclass
class Utterance:
    paths: Tuple[str, ...]  # (mix, s1, ..., sC)
    num_samples: int


@dataclass
class Batch:
    """Host-side batch with static shapes: mixture [B, T] float32, lengths
    [B] int32 true sample counts, sources [B, C, T], weights [B] float32
    (0 for padding rows)."""

    mixture: np.ndarray
    lengths: np.ndarray
    sources: np.ndarray
    weights: np.ndarray


def _load_infos(json_dir: str, num_speakers: int) -> List[Utterance]:
    parts = ["mix"] + [f"s{i + 1}" for i in range(num_speakers)]
    lists = []
    for part in parts:
        with open(os.path.join(json_dir, part + ".json")) as f:
            lists.append(json.load(f))
    utts = []
    for rows in zip(*lists):
        n = int(rows[0][1])
        if any(int(r[1]) != n for r in rows):
            raise ValueError(f"length mismatch: {rows}")
        utts.append(Utterance(tuple(r[0] for r in rows), n))
    utts.sort(key=lambda u: u.num_samples, reverse=True)
    return utts


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class SeparationDataset:
    """Static minibatch plan over the manifest JSONs in ``json_dir``;
    ``segment < 0`` selects full-utterance (cv/tt) mode."""

    def __init__(
        self,
        json_dir: str,
        batch_size: int,
        sample_rate: int = 8000,
        segment: float = 4.0,
        cv_maxlen: float = 8.0,
        max_hours: Optional[float] = None,
        num_speakers: int = 2,
        pad_rows_to_multiple: int = 1,
        cv_skip_semantics: str = "fixed",
    ):
        if cv_skip_semantics not in ("fixed", "reference"):
            raise ValueError(
                f"cv_skip_semantics must be 'fixed' or 'reference', "
                f"got {cv_skip_semantics!r}")
        self.json_dir = json_dir
        self.batch_size = batch_size
        # zero-weight rows round the row count up to this multiple
        self.pad_rows_to_multiple = max(1, pad_rows_to_multiple)
        self.sample_rate = sample_rate
        self.segment = segment
        self.segment_len = int(segment * sample_rate) if segment >= 0 else -1
        self.cv_maxlen = cv_maxlen
        self.cv_skip_semantics = cv_skip_semantics
        self.num_speakers = num_speakers
        utts = _load_infos(json_dir, num_speakers)
        if segment >= 0:
            self.plan = self._plan_segments(utts, max_hours)
        else:
            self.plan = self._plan_full(utts, max_hours)

    def _plan_segments(self, utts: List[Utterance],
                       max_hours: Optional[float]) -> List[List[Utterance]]:
        seg, bs, sr = self.segment_len, self.batch_size, self.sample_rate
        plan: List[List[Utterance]] = []
        hours = 0.0
        start = 0
        n = len(utts)
        while start < n:
            batch: List[Utterance] = []
            num_segments = 0
            i = start
            while num_segments < bs and i < n:
                u = utts[i]
                if u.num_samples >= seg:  # shorter utterances are dropped
                    add = math.ceil(u.num_samples / seg)
                    if num_segments + add > bs and batch:
                        break  # the utterance spills into the next batch
                    batch.append(u)
                    num_segments += add
                    hours += min(u.num_samples, seg * bs) / sr / 3600
                i += 1
            if batch:
                plan.append(batch)
            if i >= n:
                break
            if max_hours is not None and hours > max_hours:
                break
            start = i
        return plan

    def _plan_full(self, utts: List[Utterance],
                   max_hours: Optional[float]) -> List[List[Utterance]]:
        bs, sr = self.batch_size, self.sample_rate
        maxlen = self.cv_maxlen * sr
        plan: List[List[Utterance]] = []
        hours = 0.0
        start = 0
        n = len(utts)
        while start < n:
            if utts[start].num_samples > maxlen:
                start = (min(n, start + bs)
                         if self.cv_skip_semantics == "reference"
                         else start + 1)
                continue
            end = min(n, start + bs)
            hours += utts[start].num_samples / sr / 3600
            plan.append(utts[start:end])
            if max_hours is not None and hours > max_hours:
                break
            start = end
        return plan

    def __len__(self) -> int:
        return len(self.plan)

    def batch_shapes(self, pad_to_multiple: int = 1):
        """Distinct ``(rows, T)`` mixture shapes of the plan, from the
        manifests alone (no decode), padded as ``load_batch`` pads."""
        m = self.pad_rows_to_multiple
        if self.segment_len >= 0:
            if not self.plan:
                return []
            return [(_round_up(self.batch_size, m), self.segment_len)]
        shapes = set()
        for utts in self.plan:
            maxT = max(u.num_samples for u in utts)
            shapes.add((_round_up(len(utts), m),
                        _round_up(maxT, pad_to_multiple)))
        return sorted(shapes)

    def load_batch(self, index: int, pad_to_multiple: int = 1) -> Batch:
        """Decode one planned batch into fixed-shape arrays: segment rows
        (full strides, then the re-anchored tail) padded with zero-weight
        rows to ``batch_size``; or whole utterances zero-padded to the
        batch's longest, rounded up to ``pad_to_multiple``."""
        utts = self.plan[index]
        C = self.num_speakers
        m = self.pad_rows_to_multiple
        mixes: List[np.ndarray] = []
        sources: List[np.ndarray] = []
        if self.segment_len >= 0:
            seg, bs = self.segment_len, self.batch_size
            for u in utts:
                waves = load_waves(u.paths, self.sample_rate)
                mix, srcs = waves[0], np.stack(waves[1:], axis=0)
                T = mix.shape[-1]
                max_index = min(T - seg + 1, (bs - 1) * seg + 1)
                for s in range(0, max_index, seg):
                    mixes.append(mix[s:s + seg])
                    sources.append(srcs[:, s:s + seg])
                if T % seg != 0 and T < bs * seg:
                    mixes.append(mix[-seg:])
                    sources.append(srcs[:, -seg:])
            B = len(mixes)
            assert B <= bs, (B, bs)   # the plan caps segments per batch
            rows = _round_up(bs, m)
            mixture = np.zeros((rows, seg), np.float32)
            src_arr = np.zeros((rows, C, seg), np.float32)
            lengths = np.full((rows,), seg, np.int32)
            weights = np.zeros((rows,), np.float32)
            for b in range(B):
                mixture[b] = mixes[b]
                src_arr[b] = sources[b]
                weights[b] = 1.0
            return Batch(mixture, lengths, src_arr, weights)

        for u in utts:
            waves = load_waves(u.paths, self.sample_rate)
            mixes.append(waves[0])
            sources.append(np.stack(waves[1:], axis=0))
        B = len(mixes)
        rows = _round_up(B, m)
        maxT = _round_up(max(mx.shape[-1] for mx in mixes), pad_to_multiple)
        mixture = np.zeros((rows, maxT), np.float32)
        src_arr = np.zeros((rows, C, maxT), np.float32)
        # padding rows keep a nonzero length (no 0-division in the loss);
        # their weight is 0
        lengths = np.full((rows,), maxT, np.int32)
        weights = np.zeros((rows,), np.float32)
        for b in range(B):
            T = mixes[b].shape[-1]
            mixture[b, :T] = mixes[b]
            src_arr[b, :, :T] = sources[b]
            lengths[b] = T
            weights[b] = 1.0
        return Batch(mixture, lengths, src_arr, weights)


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
        maxT = _round_up(maxT, pad_to_multiple)
        mixture = np.zeros((len(waves), maxT), np.float32)
        lengths = np.zeros((len(waves),), np.int32)
        for b, w in enumerate(waves):
            mixture[b, : w.shape[-1]] = w
            lengths[b] = w.shape[-1]
        return mixture, lengths, [r[0] for r in rows]
