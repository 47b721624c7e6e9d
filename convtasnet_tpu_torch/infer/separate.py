"""Deployment separation: mixture wavs in, per-speaker wavs out.

Counterpart of the batch mode of ``convtasnet_tpu/infer/separate.py``:
loads an inference package, builds the manifest from a mixture directory
if needed, batches length-sorted mixtures padded to a multiple of
``pad_to_multiple`` samples, and writes ``<utt>.wav`` (the mixture) plus
``<utt>_s{c}.wav`` per speaker. ``streaming=True`` runs the causal
streaming separator (``models/streaming.py``) chunk by chunk instead, as
the JAX package's ``_separate_streaming`` does. ``tensor_parallel=m``
serves a package split over m shards (``parallel/tensor_parallel.
tp_forward``): a TCN's hidden width, a dual-path model's heads and FFN
width (``parallel/dpt_tp.py``), as the JAX package's
``_separate_tensor_parallel`` does; the sequence-parallel mode (ROADMAP
A8d) is not ported yet and raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from convtasnet_tpu_torch.data.audio_io import write_wav
from convtasnet_tpu_torch.data.dataset import EvalDataset
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.streaming import StreamingSeparator
from convtasnet_tpu_torch.parallel.mesh import shard_devices
from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward
from convtasnet_tpu_torch.train.checkpoint import load_params_for_inference
from convtasnet_tpu_torch.utils.padding import remove_pad


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and CUDA is
    absent (there is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain path on the CPU")
    return device


def separate(
    model_path: str,
    out_dir: str,
    mix_dir: Optional[str] = None,
    mix_json: Optional[str] = None,
    batch_size: int = 1,
    sample_rate: int = 8000,
    pad_to_multiple: int = 8000,
    write_mix: bool = True,
    streaming: bool = False,
    chunk_seconds: float = 0.5,
    sequence_parallel: bool = False,
    ring_attention: bool = False,
    use_pallas: Optional[bool] = None,
    tensor_parallel: int = 0,
    device="cuda",
) -> int:
    """Separate every mixture; returns the number of utterances written.

    ``use_pallas``: run the model's hand-written kernels, the TCN block's
    or the DPT sublayers' (None = on for a CUDA device). Each batch runs
    as one forward call. ``streaming=True`` separates each mixture in
    chunks of ``chunk_seconds`` (whole encoder hops) through the causal
    streaming separator, which needs a causal cLN or BN package and runs
    the plain ops, as the JAX streaming step does. ``tensor_parallel=m >
    1`` splits a TCN package's hidden width, or a dual-path package's heads
    and FFN width, over m shards (``mesh.shard_devices(m, device)``: all on
    one card where there is one), one ``tp_forward`` per batch: gLN blocks
    through kernel B6, the dual-path sublayers through the partial
    kernels.
    """
    if sequence_parallel or ring_attention:
        raise NotImplementedError(
            "sequence-parallel separation is not ported yet (ROADMAP A8d)")
    device = resolve_device(device)
    cfg, state_dict = load_params_for_inference(model_path)
    if streaming:
        return _separate_streaming(cfg, state_dict, out_dir, mix_dir,
                                   mix_json, sample_rate, chunk_seconds,
                                   write_mix, device)
    if tensor_parallel > 1:
        devices = shard_devices(tensor_parallel, device)
        variables = {k: v.to(devices[0]) for k, v in state_dict.items()}

        def forward(mixture: torch.Tensor) -> torch.Tensor:
            return tp_forward(cfg, variables, mixture, devices,
                              use_pallas=use_pallas)
    else:
        model = ConvTasNet(cfg, use_pallas=use_pallas, device=device)
        model.load_state_dict(state_dict)
        model.eval()
        forward = model
    ds = EvalDataset(mix_dir=mix_dir, mix_json=mix_json,
                     batch_size=batch_size, sample_rate=sample_rate)
    os.makedirs(out_dir, exist_ok=True)

    def write(est_dev, mixture, lengths, names) -> int:
        est_list = remove_pad(est_dev.cpu().numpy(), lengths)
        mix_list = remove_pad(mixture, lengths)
        for b, name in enumerate(names):
            stem = os.path.splitext(os.path.basename(name))[0]
            if write_mix:
                write_wav(os.path.join(out_dir, stem + ".wav"), mix_list[b],
                          sample_rate)
            for c in range(cfg.num_speakers):
                write_wav(os.path.join(out_dir, f"{stem}_s{c + 1}.wav"),
                          est_list[b][c], sample_rate)
        return len(names)

    # one-deep pipeline: queue batch i+1 on the device before writing batch
    # i, so decoding and wav writes on the host overlap the device's work
    n_written = 0
    pending = None
    with torch.inference_mode():
        for bi in range(len(ds)):
            mixture, lengths, names = ds.load_batch(
                bi, pad_to_multiple=pad_to_multiple)
            est_dev = forward(torch.from_numpy(mixture).to(device))
            if pending is not None:
                n_written += write(*pending)
            pending = (est_dev, mixture, lengths, names)
        if pending is not None:
            n_written += write(*pending)
    return n_written


def _separate_streaming(cfg, state_dict, out_dir, mix_dir, mix_json,
                        sample_rate, chunk_seconds, write_mix,
                        device) -> int:
    """Chunk-by-chunk separation with the streaming separator, one
    utterance at a time."""
    sep = StreamingSeparator(cfg, state_dict, batch_size=1, device=device)
    ds = EvalDataset(mix_dir=mix_dir, mix_json=mix_json, batch_size=1,
                     sample_rate=sample_rate)
    os.makedirs(out_dir, exist_ok=True)
    hop = cfg.stride
    chunk = max(hop, int(chunk_seconds * sample_rate) // hop * hop)
    for bi in range(len(ds)):
        mixture, lengths, names = ds.load_batch(bi)
        T = int(lengths[0])
        x = np.zeros((1, -(-T // chunk) * chunk), np.float32)
        x[0, :T] = mixture[0, :T]
        sep.reset()
        outs = [sep.process(torch.from_numpy(x[:, s:s + chunk])).cpu()
                for s in range(0, x.shape[1], chunk)]
        outs.append(sep.flush().cpu())
        est = torch.cat(outs, dim=-1)[0, :, :T].numpy()
        stem = os.path.splitext(os.path.basename(names[0]))[0]
        if write_mix:
            write_wav(os.path.join(out_dir, stem + ".wav"), mixture[0, :T],
                      sample_rate)
        for c in range(cfg.num_speakers):
            write_wav(os.path.join(out_dir, f"{stem}_s{c + 1}.wav"), est[c],
                      sample_rate)
    return len(ds)
