"""Signal framing and overlap-add on ``[..., T]`` tensors.

Counterpart of ``convtasnet_tpu/ops/frames.py``: framing is a subframe
reshape plus ``L // hop`` shifted slices when the hop divides the frame
length (the Conv-TasNet default, L=20 / hop=10), and overlap-add is its
adjoint. Other (length, hop) pairs go through a gcd-subframe index path,
with the reference's contract ``Tout = (K-1)*hop + L``.
"""

from __future__ import annotations

import math

import torch


def num_frames(num_samples: int, frame_length: int, frame_step: int) -> int:
    """Number of full frames, as a VALID strided conv: (T - L)//hop + 1."""
    return (num_samples - frame_length) // frame_step + 1


def frame_signal(x: torch.Tensor, frame_length: int,
                 frame_step: int) -> torch.Tensor:
    """Frame ``[..., T]`` into ``[..., K, frame_length]``; trailing samples
    that do not fill a frame are dropped."""
    T = x.shape[-1]
    K = num_frames(T, frame_length, frame_step)
    if K <= 0:
        raise ValueError(
            f"signal length {T} shorter than frame length {frame_length}")
    if frame_length % frame_step == 0:
        q = frame_length // frame_step
        n_sub = T // frame_step
        sub = x[..., : n_sub * frame_step].reshape(
            *x.shape[:-1], n_sub, frame_step)
        return torch.cat([sub[..., i: i + K, :] for i in range(q)], dim=-1)
    starts = torch.arange(K, device=x.device) * frame_step
    idx = starts[:, None] + torch.arange(frame_length, device=x.device)[None, :]
    return x[..., idx]


def overlap_and_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
    """Overlap-add ``[..., K, L]`` at hop ``frame_step`` -> ``[..., Tout]``,
    ``Tout = (K-1)*frame_step + L``."""
    *outer, K, L = frames.shape
    if frame_step > L:
        raise ValueError(f"frame_step {frame_step} > frame_length {L}")
    out_size = (K - 1) * frame_step + L

    if L % frame_step == 0:
        q = L // frame_step
        sub = frames.reshape(*outer, K, q, frame_step)
        out = frames.new_zeros((*outer, out_size // frame_step, frame_step))
        for i in range(q):
            out[..., i: i + K, :] += sub[..., :, i, :]
        return out.reshape(*outer, out_size)

    # gcd-subframe path: subframe s of frame k lands at output subframe
    # k*sub_step + s
    g = math.gcd(L, frame_step)
    sub_per_frame = L // g
    sub_step = frame_step // g
    ids = (torch.arange(K, device=frames.device)[:, None] * sub_step
           + torch.arange(sub_per_frame, device=frames.device)[None, :]
           ).reshape(-1)
    flat = frames.reshape(-1, K * sub_per_frame, g)
    out = flat.new_zeros((flat.shape[0], out_size // g, g))
    out.index_add_(1, ids, flat)
    return out.reshape(*outer, out_size)
