"""Padding utilities (counterpart of ``convtasnet_tpu/utils/padding.py``)."""

from __future__ import annotations

from typing import List

import numpy as np


def remove_pad(inputs, lengths) -> List[np.ndarray]:
    """Strip per-utterance padding.

    Args:
        inputs: [B, C, T] or [B, T] array.
        lengths: [B] true sample counts.

    Returns:
        list of B numpy arrays, [C, T_b] or [T_b].
    """
    inputs = np.asarray(inputs)
    lengths = np.asarray(lengths)
    return [row[..., : int(n)].copy() for row, n in zip(inputs, lengths)]
