"""Utterance-level permutation-invariant SI-SNR objective (uPIT).

Counterpart of ``convtasnet_tpu/losses/pit.py``: zero-mean over the true
(unpadded) lengths, the pairwise CxC SI-SNR matrix by broadcasting, the C!
permutation search as one product with constant one-hot permutation
matrices, loss = -mean(max-over-perms SI-SNR / C). All math in float32
whatever the model's compute dtype; the caller's tensors are not changed.
"""

from __future__ import annotations

import functools
from itertools import permutations
from typing import Tuple

import numpy as np
import torch

EPS = 1e-8


@functools.lru_cache(maxsize=8)
def _perm_one_hots(C: int) -> Tuple[np.ndarray, np.ndarray]:
    """[C!, C, C] one-hot permutation matrices and the [C!, C] perms."""
    perms = np.array(list(permutations(range(C))), dtype=np.int64)
    one_hot = np.zeros((perms.shape[0], C, C), dtype=np.float32)
    one_hot[np.arange(perms.shape[0])[:, None], np.arange(C)[None, :],
            perms] = 1.0
    return one_hot, perms


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, T] {0, 1} float mask."""
    t = torch.arange(T, device=lengths.device)[None, :]
    return (t < lengths[:, None]).float()[:, None, :]


def pit_si_snr(source: torch.Tensor, estimate: torch.Tensor,
               lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-over-permutations SI-SNR of [B, C, T] references and estimates
    with [B] true lengths -> (max_snr [B], the mean over speakers under the
    best permutation; best_perm [B, C], the estimate channel that plays
    each reference channel's role)."""
    source = source.float()
    estimate = estimate.float()
    B, C, T = source.shape
    mask = length_mask(lengths, T)
    estimate = estimate * mask

    num = lengths.float()[:, None, None]
    zm_target = (source - source.sum(dim=2, keepdim=True) / num) * mask
    zm_estimate = (estimate - estimate.sum(dim=2, keepdim=True) / num) * mask

    s_target = zm_target[:, None, :, :]      # [B, 1, C, T]
    s_estimate = zm_estimate[:, :, None, :]  # [B, C, 1, T]
    pair_dot = (s_estimate * s_target).sum(dim=3, keepdim=True)
    target_energy = (s_target ** 2).sum(dim=3, keepdim=True) + EPS
    proj = pair_dot * s_target / target_energy      # [B, C, C, T]
    noise = s_estimate - proj
    ratio = (proj ** 2).sum(dim=3) / ((noise ** 2).sum(dim=3) + EPS)
    pair_si_snr = 10.0 * torch.log10(ratio + EPS)  # [B, C, C] (est i, ref j)

    one_hot, perms = _perm_one_hots(C)
    snr_set = torch.einsum("bij,pij->bp", pair_si_snr,
                           torch.from_numpy(one_hot).to(source.device))
    max_snr, best_idx = snr_set.max(dim=1)
    best_perm = torch.from_numpy(perms).to(source.device)[best_idx]
    return max_snr / C, best_perm


def reorder_source(source: torch.Tensor,
                   best_perm: torch.Tensor) -> torch.Tensor:
    """Align estimates to reference channels: out[b, c] =
    source[b, inv_perm[b, c]]. ``best_perm[b, i] = j`` means estimate i
    plays reference j, so reference c is played by estimate inv_perm[c]
    (the inverse, which differs from the permutation for 3-cycles at
    C >= 3)."""
    inv_perm = torch.argsort(best_perm, dim=1)
    index = inv_perm[:, :, None].expand(-1, -1, source.shape[-1])
    return torch.gather(source, 1, index)


def si_snr_single(reference: torch.Tensor,
                  estimate: torch.Tensor) -> torch.Tensor:
    """Plain (non-PIT) SI-SNR of [..., T] signal pairs, zero-mean over the
    full length."""
    reference = reference.float()
    estimate = estimate.float()
    ref_zm = reference - reference.mean(dim=-1, keepdim=True)
    est_zm = estimate - estimate.mean(dim=-1, keepdim=True)
    proj = ((ref_zm * est_zm).sum(dim=-1, keepdim=True) * ref_zm
            / ((ref_zm ** 2).sum(dim=-1, keepdim=True) + EPS))
    noise = est_zm - proj
    return 10.0 * torch.log10(((proj ** 2).sum(dim=-1) + EPS)
                              / ((noise ** 2).sum(dim=-1) + EPS))


def cal_loss(source: torch.Tensor, estimate: torch.Tensor,
             lengths: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (loss = -mean(max_snr), max_snr [B], estimates reordered to the
    references [B, C, T])."""
    max_snr, best_perm = pit_si_snr(source, estimate, lengths)
    return -max_snr.mean(), max_snr, reorder_source(estimate, best_perm)
