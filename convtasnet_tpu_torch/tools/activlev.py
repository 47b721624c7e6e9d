"""ITU-T P.56 active speech level meter.

The port's own copy of ``convtasnet_tpu/tools/activlev.py`` (numpy and
scipy, the same names and numbers; ``tests/test_torch_tools.py``).

Capability parity with the vendored voicebox ``activlev.m`` (reference
``tools/matlab-code/activlev.m``, used by the wsj0-2mix generator as
``[y, lev] = activlev(x, fs, 'n')`` to loudness-normalize each source before
mixing, ``create_wav_2speakers.m:89-91``). This is an independent numpy
implementation of the published ITU-T P.56 method B:

1. optional band-limit to the P.56 measurement band (200 Hz - 5.5 kHz;
   high-pass side only at narrowband rates),
2. envelope ``q`` from two cascaded exponential averagers with time constant
   0.03 s,
3. for a ladder of binary thresholds ``c_j``, count samples active
   (``q >= c_j``) extended by a 0.2 s hangover,
4. active level A_j = 10 log10(energy / active_count_j); the measured level
   is where the margin A_j - 20 log10(c_j) crosses 15.9 dB, interpolated
   between adjacent thresholds in dB.

Returns the active level as mean-square power (linear), matching the
``y / sqrt(lev)`` normalization convention of the reference pipeline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MARGIN_DB = 15.9     # P.56 margin between active level and threshold
TIME_CONST = 0.03    # envelope smoothing time constant (s)
HANGOVER = 0.2       # hangover time (s)


def _envelope(x: np.ndarray, fs: int) -> np.ndarray:
    """Two cascaded exponential averagers of |x| (P.56 q(t))."""
    from scipy.signal import lfilter

    g = np.exp(-1.0 / (fs * TIME_CONST))
    b, a = [1.0 - g], [1.0, -g]
    p = lfilter(b, a, np.abs(x))
    q = lfilter(b, a, p)
    return q


def _active_counts(q: np.ndarray, thresholds: np.ndarray, hang: int) -> np.ndarray:
    """Per-threshold active sample counts with forward hangover extension."""
    T = q.shape[0]
    t_idx = np.arange(T)
    counts = np.zeros(len(thresholds), dtype=np.int64)
    for j, c in enumerate(thresholds):
        active = q >= c
        if not active.any():
            continue
        # last active index at or before t (-inf where none yet)
        last = np.maximum.accumulate(np.where(active, t_idx, -hang - 1))
        counts[j] = int(np.count_nonzero(t_idx - last <= hang))
    return counts


def active_level(
    x: np.ndarray, fs: int, highpass: bool = True
) -> Tuple[float, float]:
    """-> (active_power, activity_factor).

    ``active_power`` is the mean-square level over active speech (linear);
    ``activity_factor`` in (0, 1] is the active fraction of the signal.
    Falls back to the long-term power for degenerate signals (all-silence or
    constant envelope) rather than raising.
    """
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        x = x.reshape(-1)
    m = x
    if highpass and fs > 1000:
        # P.56 measurement band: 200 Hz - 5.5 kHz (voicebox activlev.m
        # default flh=[200 5500], 5th-order designs with -50 dB stopbands,
        # activlev.m:144-154); below-11 kHz rates get the high-pass side only
        from scipy.signal import butter, lfilter

        ny = fs / 2
        if 5500.0 < ny:
            b, a = butter(5, [200.0 / ny, 5500.0 / ny], btype="bandpass")
        else:
            b, a = butter(5, 200.0 / ny, btype="highpass")
        m = lfilter(b, a, x)
    energy = float(np.sum(m ** 2))
    T = m.shape[0]
    if T == 0 or energy <= 0:
        return 0.0, 0.0
    long_term = energy / T

    q = _envelope(m, fs)
    qmax = float(q.max())
    if qmax <= 0:
        return long_term, 1.0
    # binary threshold ladder spanning the envelope's dynamic range
    n_thr = 32
    top = np.ceil(np.log2(qmax))
    thresholds = 2.0 ** np.arange(top - n_thr + 1, top + 1)
    hang = int(round(HANGOVER * fs))
    counts = _active_counts(q, thresholds, hang)

    valid = counts > 0
    if not valid.any():
        return long_term, 1.0
    A = 10.0 * np.log10(energy / counts[valid])          # active level per thr
    C = 20.0 * np.log10(thresholds[valid])               # threshold in dB
    d = A - C                                            # margin
    # d decreases with rising threshold; find crossing of MARGIN_DB
    below = np.nonzero(d <= MARGIN_DB)[0]
    if len(below) == 0:
        # margin never reached: activity ~ 1 (e.g. stationary noise)
        return long_term, 1.0
    k = below[0]
    if k == 0:
        act_db = A[0]
    else:
        # linear interpolation in dB between thresholds k-1 and k
        d0, d1 = d[k - 1], d[k]
        a0, a1 = A[k - 1], A[k]
        w = (d0 - MARGIN_DB) / (d0 - d1) if d0 != d1 else 0.0
        act_db = a0 + w * (a1 - a0)
    active_power = float(10.0 ** (act_db / 10.0))
    activity = min(1.0, long_term / active_power) if active_power > 0 else 1.0
    return active_power, activity


def normalize_active(
    x: np.ndarray, fs: int, highpass: bool = True
) -> Tuple[np.ndarray, float]:
    """-> (x / sqrt(active_power), active_power): the ``activlev(x, fs, 'n')``
    convention used by the mixture generator (``create_wav_2speakers.m:89``)."""
    lev, _ = active_level(x, fs, highpass=highpass)
    if lev <= 0:
        return np.asarray(x, np.float64), 1.0
    return np.asarray(x, np.float64) / np.sqrt(lev), lev
