"""One-command WSJ0 stage 0: raw sphere disc tree -> finished mixture trees.

The port's own copy of ``convtasnet_tpu/tools/wsj0.py`` (the same names and
tree).

The reference needs three manual tools for this: the external ``sph2pipe``
binary looped by ``egs/wsj0/local/data_prepare.sh:13-37`` (sphere -> wav,
preserving the ``<set>/<speaker>/<utt>`` layout), then MATLAB
``create_wav_2speakers.m:33-188`` driven by the MERL ``mix_2_spk_*.txt``
pairing lists (8k & 16k, min & max variants). Here one call does all of it:

    prepare_wsj0(wsj0_root, lists_dir, out_root)

- walks ``wsj0_root`` for ``.wv1``/``.wv2`` under the WSJ0 SI sets
  (``si_tr_s``, ``si_dt_05``, ``si_et_05`` — the same ``find | grep`` as
  data_prepare.sh), decoding each shorten-compressed SPHERE file natively
  (``data/shorten.py``; no sph2pipe) into
  ``out_root/wsj0-wav/<set>/<spk>/<utt>.wav``,
- reads the MERL lists (rows ``path1 snr1 path2 snr2``; entries may use
  ``.wv1`` or ``.wav`` extensions and any leading prefix — they resolve by
  their last three path components),
- emits ``out_root/wav{8,16}k/{min,max}/{tr,cv,tt}/{mix,s1,s2}`` plus
  per-variant ``scaling.npz`` via the P.56-normalized mixture generator
  (``tools/mixture.py``).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

from convtasnet_tpu_torch.data.audio_io import read_wav, write_wav
from convtasnet_tpu_torch.tools.mixture import (
    MixRow,
    create_mixtures_multi,
    read_pair_list,
)

# The SI sets used by wsj0-2mix (data_prepare.sh:25 grep list).
SETS = ("si_tr_s", "si_dt_05", "si_et_05")
SPLIT_LISTS = {"tr": "mix_2_spk_tr.txt",
               "cv": "mix_2_spk_cv.txt",
               "tt": "mix_2_spk_tt.txt"}


def find_sphere_files(wsj0_root: str,
                      sets: Sequence[str] = SETS) -> list:
    """All ``.wv1``/``.wv2`` files under directories belonging to ``sets``
    (the disc layout nests them as ``.../<disc>/wsj0/<set>/<spk>/``)."""
    found = []
    for dirpath, _, files in os.walk(wsj0_root):
        parts = dirpath.replace(os.sep, "/").split("/")
        if not any(s in parts for s in sets):
            continue
        for name in files:
            if name.lower().endswith((".wv1", ".wv2")):
                found.append(os.path.join(dirpath, name))
    return sorted(found)


def decode_sphere_tree(wsj0_root: str, wav_root: str,
                       sets: Sequence[str] = SETS,
                       verbose: bool = True) -> int:
    """Decode every sphere file into ``wav_root/<set>/<spk>/<utt>.wav``
    (the last three path components, like data_prepare.sh's awk). Existing
    outputs are skipped, so re-runs are incremental. Returns #decoded."""
    n = 0
    for src in find_sphere_files(wsj0_root, sets):
        parts = src.replace(os.sep, "/").split("/")
        stem = os.path.splitext(parts[-1])[0]
        dst = os.path.join(wav_root, parts[-3], parts[-2], stem + ".wav")
        if os.path.exists(dst):
            continue
        x, sr = read_wav(src)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        write_wav(dst, x, sr)
        n += 1
        if verbose and n % 500 == 0:
            print(f"decoded {n} sphere files...", file=sys.stderr)
    return n


def _resolve(entry: str, wav_root: str) -> str:
    """Map a list entry (e.g. ``wsj0/si_tr_s/011/011c0201.wv1``) to its
    decoded wav path by its last three components."""
    parts = entry.replace("\\", "/").strip("/").split("/")
    tail = parts[-3:]
    stem, ext = os.path.splitext(tail[-1])
    if ext.lower() in (".wv1", ".wv2", ".sph"):
        tail[-1] = stem + ".wav"
    return os.path.join(wav_root, *tail)


def prepare_wsj0(
    wsj0_root: str,
    lists_dir: str,
    out_root: str,
    sample_rates: Sequence[int] = (8000, 16000),
    modes: Sequence[str] = ("min", "max"),
    splits: Sequence[str] = ("tr", "cv", "tt"),
    num_speakers: int = 2,
    verbose: bool = True,
) -> Dict[str, int]:
    """Raw WSJ0 disc tree + MERL pairing lists -> finished wsj0-``C``mix
    trees. Returns {split: #mixtures}. ``lists_dir`` must contain
    ``mix_2_spk_{tr,cv,tt}.txt`` (or ``mix_<C>_spk_...`` for C != 2)."""
    wav_root = os.path.join(out_root, "wsj0-wav")
    n = decode_sphere_tree(wsj0_root, wav_root, verbose=verbose)
    if verbose:
        print(f"sphere decode: {n} new files -> {wav_root}", file=sys.stderr)
    summary: Dict[str, int] = {}
    for split in splits:
        name = SPLIT_LISTS[split]
        if num_speakers != 2:
            name = name.replace("mix_2_spk", f"mix_{num_speakers}_spk")
        list_path = os.path.join(lists_dir, name)
        rows = read_pair_list(list_path)
        rows = [MixRow(tuple(_resolve(p, wav_root) for p in r.paths), r.snrs)
                for r in rows]
        missing = [p for r in rows for p in r.paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} source wavs from {list_path} not found "
                f"under {wav_root} (first: {missing[0]}) — check --wsj0-root "
                f"covers every disc")
        names = create_mixtures_multi(
            rows, out_root, sample_rates=sample_rates, modes=modes,
            split=split)
        summary[split] = len(names)
        if verbose:
            print(f"{split}: {len(names)} mixtures x "
                  f"{len(sample_rates) * len(modes)} variants",
                  file=sys.stderr)
    return summary
