"""Evaluation: SI-SNRi (and optional SDRi) on a mixture/sources test set.

Counterpart of ``convtasnet_tpu/infer/evaluate.py``: loads an inference
package or a training checkpoint, runs full-utterance batches
(``SeparationDataset`` with ``segment=-1``, zero-padded to a multiple of
``pad_to_multiple`` samples), PIT-aligns the estimates
(``losses/pit.py``), and reports per-utterance and average SI-SNR
improvement over the mixture-as-estimate baseline. The zero-mean and the
energies honour each utterance's true length and are taken on the device;
only the per-utterance scalars come back. ``cal_sdr`` adds SDRi through
``bss_eval`` on the host, which is far slower than the network.

Each batch is one forward: the JAX package's ``batch_chunk``, which splits
a batch to fit TPU VMEM, has no counterpart here (``cli evaluate`` accepts
the flag and ignores it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from convtasnet_tpu_torch.data.dataset import SeparationDataset
from convtasnet_tpu_torch.infer.separate import resolve_device
from convtasnet_tpu_torch.losses.pit import pit_si_snr, reorder_source
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.train.checkpoint import load_params_for_inference


def masked_sisnr_batch(est: torch.Tensor, src: torch.Tensor,
                       mix: torch.Tensor, lengths: torch.Tensor):
    """Per-utterance SI-SNRi of PIT-aligned estimates [B, C, T] against the
    sources [B, C, T]: the mean over speakers of SI-SNR(estimate) minus
    that of the mixture [B, T] as the estimate, over the true lengths.
    -> (si_snri, si_snr_est, si_snr_mix), each [B]."""
    T = src.shape[-1]
    mask = (torch.arange(T, device=src.device)[None, :]
            < lengths[:, None]).float()
    n = lengths.float().clamp_min(1.0)[:, None]

    def masked_sisnr(ref, est_sig):
        ref = (ref - (ref * mask).sum(-1, keepdim=True) / n) * mask
        est_sig = (est_sig - (est_sig * mask).sum(-1, keepdim=True) / n) * mask
        proj = ((ref * est_sig).sum(-1, keepdim=True) * ref
                / ((ref * ref).sum(-1, keepdim=True) + 1e-8))
        noise = est_sig - proj
        return 10.0 * torch.log10(((proj ** 2).sum(-1) + 1e-8)
                                  / ((noise ** 2).sum(-1) + 1e-8))

    C = src.shape[1]
    sisnr_est = torch.stack([masked_sisnr(src[:, c], est[:, c])
                             for c in range(C)]).mean(0)
    sisnr_mix = torch.stack([masked_sisnr(src[:, c], mix)
                             for c in range(C)]).mean(0)
    return sisnr_est - sisnr_mix, sisnr_est, sisnr_mix


def evaluate(
    model_path: str,
    data_dir: str,
    batch_size: int = 1,
    sample_rate: int = 8000,
    cal_sdr: bool = False,
    max_batches: Optional[int] = None,
    pad_to_multiple: int = 8000,
    verbose: bool = True,
    use_pallas: Optional[bool] = None,
    device="cuda",
) -> Dict[str, float]:
    """-> {"si_snri": average dB, "sdri": average dB (with cal_sdr)} over the
    test set whose manifests are in ``data_dir``.

    ``use_pallas``: run the model's hand-written kernels (None = on for a
    CUDA device). ``device`` defaults to CUDA and raises when it is absent.
    """
    device = resolve_device(device)
    cfg, state_dict = load_params_for_inference(model_path)
    model = ConvTasNet(cfg, use_pallas=use_pallas, device=device)
    model.load_state_dict(state_dict)
    model.eval()
    ds = SeparationDataset(
        data_dir, batch_size, sample_rate, segment=-1.0,
        cv_maxlen=float("inf"), num_speakers=cfg.num_speakers)

    def run(batch):
        mixture = torch.from_numpy(batch.mixture).to(device)
        sources = torch.from_numpy(batch.sources).to(device)
        lengths = torch.from_numpy(batch.lengths).to(device)
        est = model(mixture)
        _, best_perm = pit_si_snr(sources, est, lengths)
        est = reorder_source(est, best_perm)
        si_snri, _, _ = masked_sisnr_batch(est, sources, mixture, lengths)
        return est, si_snri

    total_sisnri, total_sdri, count = 0.0, 0.0, 0

    def consume(est_dev, si_dev, batch):
        nonlocal total_sisnri, total_sdri, count
        si_snri = si_dev.cpu().numpy()
        est_np = est_dev.cpu().numpy() if cal_sdr else None
        for b in range(len(si_snri)):
            count += 1
            total_sisnri += float(si_snri[b])
            if verbose:
                print(f"Utt {count}: SI-SNRi {float(si_snri[b]):.2f} dB",
                      flush=True)
            if cal_sdr:
                from convtasnet_tpu_torch.infer.bss_eval import (
                    bss_eval_sources,
                )

                n = int(batch.lengths[b])
                src_np = batch.sources[b, :, :n]
                mix_np = batch.mixture[b, :n]
                sdr, _, _, _ = bss_eval_sources(src_np, est_np[b][:, :n])
                sdr_mix, _, _, _ = bss_eval_sources(
                    src_np, np.tile(mix_np, (cfg.num_speakers, 1)),
                    compute_permutation=False)
                sdri = float(np.mean(sdr - sdr_mix))
                total_sdri += sdri
                if verbose:
                    print(f"Utt {count}: SDRi {sdri:.2f} dB", flush=True)

    # one-deep pipeline: queue batch i+1 on the device before collecting
    # batch i, so decoding (and BSS-Eval under cal_sdr) on the host overlaps
    # the device's work
    n_batches = len(ds) if max_batches is None else min(len(ds), max_batches)
    pending = None
    with torch.inference_mode():
        for bi in range(n_batches):
            batch = ds.load_batch(bi, pad_to_multiple=pad_to_multiple)
            est, si_snri = run(batch)
            if pending is not None:
                consume(*pending)
            pending = (est, si_snri, batch)
        if pending is not None:
            consume(*pending)
    result = {"si_snri": total_sisnri / max(count, 1)}
    if cal_sdr:
        result["sdri"] = total_sdri / max(count, 1)
    if verbose:
        print(f"Average SI-SNRi: {result['si_snri']:.2f} dB")
        if cal_sdr:
            print(f"Average SDRi: {result['sdri']:.2f} dB")
    return result
