"""BSS-Eval source-separation metrics (SDR / SIR / SAR) in numpy/scipy.

The port's own copy of ``convtasnet_tpu/infer/bss_eval.py`` (it imports
nothing of the JAX package): an implementation of the BSS-Eval v3
"sources" variant (Vincent, Gribonval & Fevotte, IEEE TASLP 2006). Each
estimate is decomposed against the true sources using least-squares
projections onto 512-tap delayed subspaces,

    s_target = P_{s_j}(est),  e_interf = P_{all s}(est) - s_target,
    e_artif  = est - P_{all s}(est),

with SDR = 10 log10 ||s_target||^2 / ||e_interf + e_artif||^2 evaluated for
every permutation and the best-SDR permutation returned, the contract of
``mir_eval.separation.bss_eval_sources(compute_permutation=True)``.
Projections are solved via block-Toeplitz normal equations with FFT-based
correlations, O(C^2 L T log T). ``tests/test_torch_evaluate.py`` holds it
to the JAX copy.
"""

from __future__ import annotations

from itertools import permutations
from typing import Tuple

import numpy as np
from scipy.linalg import solve
from scipy.signal import fftconvolve

FLEN = 512  # distortion filter length, mir_eval default


def _project(refs: np.ndarray, est: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of ``est`` onto the span of delayed refs.

    Args:
        refs: [n, T] true sources to project onto (n = 1 or C).
        est: [T] estimated source.
        flen: filter length.

    Returns:
        [T + flen - 1] projection signal.
    """
    n, T = refs.shape
    # Cross-correlations G[i,j,tau] and D[i,tau] via FFT.
    nfft = int(2 ** np.ceil(np.log2(T + flen - 1)))
    sf = np.fft.rfft(refs, n=nfft, axis=1)
    ef = np.fft.rfft(est, n=nfft)
    # Gram matrix of delayed sources: block (i,j) is toeplitz of xcorr(s_i, s_j)
    G = np.zeros((n * flen, n * flen))
    for i in range(n):
        for j in range(i, n):
            ssf = np.fft.irfft(sf[i] * np.conj(sf[j]), n=nfft)
            ss_pos = ssf[:flen]          # lags 0..flen-1 of corr(s_i, s_j)
            ss_neg = np.concatenate(([ssf[0]], ssf[-(flen - 1):][::-1]))
            # toeplitz block: first column lags of corr(s_j, s_i)... build via
            # T[a, b] = corr(s_i, s_j)[b - a]
            idx = np.arange(flen)
            lag = idx[None, :] - idx[:, None]  # [flen, flen] in [-(flen-1), flen-1]
            blk = np.where(lag >= 0, ss_pos[np.abs(lag)], ss_neg[np.abs(lag)])
            G[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = blk
            if i != j:
                G[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = blk.T
    # Cross-correlation of each delayed source with est: D[i, tau] = corr(s_i, est)[tau]
    D = np.zeros(n * flen)
    for i in range(n):
        sef = np.fft.irfft(np.conj(sf[i]) * ef, n=nfft)
        D[i * flen:(i + 1) * flen] = sef[:flen]
    try:
        C_filt = solve(G + 1e-10 * np.eye(n * flen), D, assume_a="pos")
    except np.linalg.LinAlgError:
        C_filt = np.linalg.lstsq(G, D, rcond=None)[0]
    # Apply filters: sum_i conv(s_i, h_i)
    proj = np.zeros(T + flen - 1)
    for i in range(n):
        proj += fftconvolve(refs[i], C_filt[i * flen:(i + 1) * flen])
    return proj


def _ratios(s_target, e_interf, e_artif) -> Tuple[float, float, float]:
    eps = np.finfo(np.float64).eps

    def db(num, den):
        return 10.0 * np.log10((np.sum(num ** 2) + eps) / (np.sum(den ** 2) + eps))

    sdr = db(s_target, e_interf + e_artif)
    sir = db(s_target, e_interf)
    sar = db(s_target + e_interf, e_artif)
    return sdr, sir, sar


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
    flen: int = FLEN,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (sdr [C], sir [C], sar [C], perm [C]): mir_eval-compatible contract.

    ``perm[j]`` is the estimate index assigned to reference j under the
    best-mean-SIR permutation (mir_eval resolves with SIR; we use SDR, which
    coincides in practice for separation eval).

    """
    refs = np.asarray(reference_sources, np.float64)
    ests = np.asarray(estimated_sources, np.float64)
    if refs.shape != ests.shape:
        raise ValueError(f"reference {refs.shape} and estimate {ests.shape} "
                         "shapes differ")
    C = refs.shape[0]
    T = refs.shape[1]
    FLEN_ = flen
    sdr = np.zeros((C, C))
    sir = np.zeros((C, C))
    sar = np.zeros((C, C))
    for i in range(C):  # estimate i
        # the all-sources projection is independent of j: compute once
        p_all = _project(refs, ests[i], FLEN_)
        e_artif = np.zeros(T + FLEN_ - 1)
        e_artif[:T] = ests[i]
        e_artif = e_artif - p_all
        for j in range(C):  # reference j
            s_target = _project(refs[j:j + 1], ests[i], FLEN_)
            e_interf = p_all - s_target
            sdr[i, j], sir[i, j], sar[i, j] = _ratios(s_target, e_interf, e_artif)
    if not compute_permutation:
        d = np.arange(C)
        return sdr[d, d], sir[d, d], sar[d, d], d
    best = None
    best_mean = -np.inf
    for perm in permutations(range(C)):
        mean_sdr = np.mean([sdr[perm[j], j] for j in range(C)])
        if mean_sdr > best_mean:
            best_mean = mean_sdr
            best = perm
    perm = np.array(best)
    j = np.arange(C)
    return sdr[perm, j], sir[perm, j], sar[perm, j], perm
