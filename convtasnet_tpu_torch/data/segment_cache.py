"""Decode-once memmapped cache of planned training batches.

Counterpart of ``convtasnet_tpu/data/segment_cache.py``. The plan of a
segment-mode ``SeparationDataset`` is static, yet every epoch would decode
the same wavs again. ``CachedDataset`` keeps the materialised batches in
one dense ``[n_batches, rows, 1+C, seg]`` float16 memmap (float16 keeps
quantisation ~66 dB below the signal, at half the bytes): epoch 0 decodes
and fills it, later epochs read slices with no decode. Every epoch,
epoch 0 included, trains on the float16 values. The cache key hashes the
plan itself (paths and sample counts of each batch) and the packing
geometry, so a change to manifests, batch size, segment length or speaker
count misses cleanly; a cache filled part way resumes through a per-slot
``filled`` map. The loader's threads fill distinct slots.

On by default; ``CONVTASNET_SEGMENT_CACHE=0`` turns it off, and a path
there moves the cache root (default ``~/.cache/convtasnet_tpu/segcache``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from convtasnet_tpu_torch.data.dataset import Batch, SeparationDataset

_FORMAT_VERSION = 1


def _plan_key(ds: SeparationDataset) -> str:
    """Hash of everything that determines the materialised batches."""
    h = hashlib.sha256()
    h.update(json.dumps({
        "format": _FORMAT_VERSION,
        "segment_len": ds.segment_len,
        "batch_size": ds.batch_size,
        "sample_rate": ds.sample_rate,
        "num_speakers": ds.num_speakers,
        "pad_rows_to_multiple": ds.pad_rows_to_multiple,
        "plan": [[(list(u.paths), u.num_samples) for u in b]
                 for b in ds.plan],
    }, sort_keys=True).encode())
    return h.hexdigest()[:20]


class CachedDataset:
    """``SeparationDataset``'s loading interface (``__len__``,
    ``load_batch``) over the memmapped cache. Segment mode only:
    full-utterance batches are ragged."""

    def __init__(self, dataset: SeparationDataset, cache_root: str):
        if dataset.segment_len < 0:
            raise ValueError("CachedDataset requires a segment-mode dataset")
        self.dataset = dataset
        m = dataset.pad_rows_to_multiple
        rows = -(-dataset.batch_size // m) * m
        self._shape = (len(dataset.plan), rows, 1 + dataset.num_speakers,
                       dataset.segment_len)
        self.dir = os.path.join(cache_root, f"seg-{_plan_key(dataset)}")
        os.makedirs(self.dir, exist_ok=True)
        meta_path = self._p("meta.json")
        if not os.path.exists(meta_path):
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"shape": list(self._shape),
                           "format_version": _FORMAT_VERSION}, f)
            os.replace(tmp, meta_path)
        n, r = self._shape[:2]
        self._audio = self._memmap("audio.f16", np.float16, self._shape)
        self._weights = self._memmap("weights.f32", np.float32, (n, r))
        self._filled = self._memmap("filled.u8", np.uint8, (n,))

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _memmap(self, name: str, dtype, shape) -> np.memmap:
        mode = "r+" if os.path.exists(self._p(name)) else "w+"
        return np.memmap(self._p(name), dtype, mode, shape=shape)

    def __len__(self) -> int:
        return len(self.dataset)

    def hit_fraction(self) -> float:
        return float(np.mean(self._filled[:] != 0)) if len(self) else 1.0

    def load_batch(self, index: int, pad_to_multiple: int = 1) -> Batch:
        seg = self.dataset.segment_len
        rows = self._shape[1]
        if not self._filled[index]:
            batch = self.dataset.load_batch(index, pad_to_multiple)
            self._audio[index, :, 0] = batch.mixture
            self._audio[index, :, 1:] = batch.sources
            self._weights[index] = batch.weights
            self._filled[index] = 1
        audio = np.asarray(self._audio[index], np.float32)
        return Batch(mixture=audio[:, 0],
                     lengths=np.full((rows,), seg, np.int32),
                     sources=audio[:, 1:],
                     weights=np.asarray(self._weights[index], np.float32))


def default_cache_root() -> str:
    env = os.environ.get("CONVTASNET_SEGMENT_CACHE", "")
    if env and env not in ("0", "1"):
        return env
    return os.path.expanduser("~/.cache/convtasnet_tpu/segcache")


def maybe_cache(dataset: SeparationDataset,
                enable: Optional[bool] = None,
                cache_root: Optional[str] = None):
    """``dataset`` wrapped in a ``CachedDataset`` when enabled and in
    segment mode. ``enable=None`` defers to ``CONVTASNET_SEGMENT_CACHE``
    (on unless "0"); "0" wins over ``enable=True``. A filesystem that
    refuses the cache leaves the dataset as it is."""
    if dataset.segment_len < 0:
        return dataset
    env = os.environ.get("CONVTASNET_SEGMENT_CACHE", "")
    if enable is None:
        enable = env != "0"
    if not enable or env == "0":
        return dataset
    try:
        return CachedDataset(dataset, cache_root or default_cache_root())
    except OSError:
        return dataset
