"""Streaming (low-latency) separation with the causal TCN model.

Counterpart of ``convtasnet_tpu/models/streaming.py``: a stateful
chunk-by-chunk separator whose algorithmic latency is one encoder window
(L samples, 2.5 ms at 8 kHz for L=20) plus the chunk.

Every op of the causal model is frame-local except the depthwise dilated
convs, whose left context is ``(P-1)*dilation`` frames. The carried state
is therefore

- ``sample_carry``: the last ``L - hop`` raw samples (the encoder window's
  overlap),
- ``blocks[name]``: per block, the last ``(P-1)*dilation`` normalised
  activations that feed its depthwise conv (a ring buffer),
- ``ola_carry``: the decoder's trailing ``L - hop`` overlap-add samples.

``stream_step(cfg, params, state, chunk) -> (state, out)`` emits exactly
``chunk.shape[-1]`` samples per call. With a zero initial state, the
concatenated stream plus ``stream_flush`` equals the offline causal forward
on the input left-padded with ``L - hop`` zeros. ``params`` is the model's
state_dict (``load_params_for_inference``, ``state_dict_from_jax``), so any
causal package streams unchanged.

As in the JAX package, the step runs in the parameters' dtype (float32) and
never casts to ``cfg.compute_dtype``, and its blocks run through the plain
ops (``block_forward`` with a depthwise conv that reads and writes the
block's ring buffer): the JAX streaming step reaches no Pallas kernel, so
this one launches no CUDA kernel of the package. The tensors live on the
device the caller gives ``StreamingSeparator`` (or the one ``params`` and
``state`` are on).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.functional import (
    block_forward,
    block_names,
    decode_frames,
    encode_frames,
    separator_forward,
)
from convtasnet_tpu_torch.ops.frames import overlap_and_add
from convtasnet_tpu_torch.ops.norm import batch_norm, channelwise_layer_norm

Params = Mapping[str, torch.Tensor]
State = Dict[str, Any]


def _assert_streamable(cfg: ConvTasNetConfig) -> None:
    if cfg.separator != "tcn":
        raise ValueError(
            "streaming supports the (causal) TCN separator only: dual-path "
            "attention is whole-chunk (models/dual_path.py)")
    if not cfg.causal or cfg.norm_type == "gLN":
        raise ValueError(
            "streaming requires the causal variant (causal=True with cLN or "
            "BN norms); gLN needs the whole utterance")


def init_stream_state(cfg: ConvTasNetConfig, batch_size: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> State:
    """Zero state, i.e. left zero-padding of the offline causal model."""
    _assert_streamable(cfg)
    overlap = cfg.kernel_size - cfg.stride
    kw = dict(dtype=dtype, device=device)
    return {
        "sample_carry": torch.zeros((batch_size, overlap), **kw),
        "ola_carry": torch.zeros((batch_size, cfg.num_speakers, overlap),
                                 **kw),
        "blocks": {
            name: torch.zeros(
                (batch_size, (cfg.conv_kernel - 1) * d, cfg.hidden), **kw)
            for name, d in block_names(cfg)},
    }


def _norm_stream(cfg: ConvTasNetConfig, params: Params, prefix: str,
                 h: torch.Tensor) -> torch.Tensor:
    """Per-frame norm: cLN, or BN with its running statistics."""
    gamma, beta = params[prefix + "gamma"], params[prefix + "beta"]
    if cfg.norm_type == "cLN":
        return channelwise_layer_norm(h, gamma, beta)
    return batch_norm(h, gamma, beta, params[prefix + "mean"],
                      params[prefix + "var"])


def stream_step(cfg: ConvTasNetConfig, params: Params, state: State,
                chunk: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One chunk ``[M, n*hop]`` (n >= 1 whole hops) -> ``(new_state,
    est [M, C, n*hop])``: the offline model's output at these sample
    positions."""
    _assert_streamable(cfg)
    hop, L, P = cfg.stride, cfg.kernel_size, cfg.conv_kernel
    M, n_new = chunk.shape
    if n_new <= 0 or n_new % hop:
        raise ValueError(f"a chunk must be whole hops of {hop} samples, got "
                         f"{n_new}")
    new_state: State = {"blocks": {}}

    # encoder: frame k of this step spans buf[k*hop : k*hop + L]
    buf = torch.cat([state["sample_carry"], chunk], dim=-1)
    K = n_new // hop
    sub = buf.reshape(M, -1, hop)
    frames = torch.cat([sub[:, i:i + K, :] for i in range(L // hop)], dim=-1)
    new_state["sample_carry"] = buf[:, -(L - hop):]
    w = encode_frames({"w": params["encoder.w"]}, frames)

    def run_block(name: str, d: int, y: torch.Tensor) -> torch.Tensor:
        pre = f"separator.{name}."
        halo = (P - 1) * d

        def dwconv(h, wdw):
            hbuf = torch.cat([state["blocks"][name], h], dim=1)
            new_state["blocks"][name] = hbuf[:, -halo:, :]
            out = hbuf[:, halo:halo + K, :] * wdw[P - 1]
            for p in range(P - 1):
                out = out + hbuf[:, p * d:p * d + K, :] * wdw[p]
            return out

        blk = {k: params[pre + k]
               for k in ("conv1x1", "prelu1", "dwconv", "prelu2", "pwconv")}
        return block_forward(
            blk, y, dwconv=dwconv,
            norm1=lambda h: _norm_stream(cfg, params, pre + "norm1.", h),
            norm2=lambda h: _norm_stream(cfg, params, pre + "norm2.", h))

    mask = separator_forward(
        cfg, {"bottleneck": params["separator.bottleneck"],
              "mask_conv": params["separator.mask_conv"]}, w,
        input_norm=lambda v: channelwise_layer_norm(
            v, params["separator.input_norm.gamma"],
            params["separator.input_norm.beta"]),
        run_block=run_block)

    # decoder and incremental overlap-add
    ola = overlap_and_add(decode_frames({"w": params["decoder.w"]}, w, mask),
                          hop)                       # [M, C, (K-1)*hop + L]
    ola[..., :L - hop] += state["ola_carry"]
    new_state["ola_carry"] = ola[..., K * hop:]
    return new_state, ola[..., :K * hop]


def stream_flush(cfg: ConvTasNetConfig, state: State) -> torch.Tensor:
    """The trailing ``L - hop`` partially accumulated samples."""
    return state["ola_carry"]


def stream_scan(cfg: ConvTasNetConfig, params: Params, chunks: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[State, torch.Tensor]:
    """Many chunks ``[n_chunks, M, chunk_len]`` -> ``(final_state, outputs
    [n_chunks, M, C, chunk_len])``: ``stream_step`` over each chunk in turn
    (the JAX package's ``lax.scan``), from ``state`` or zeros."""
    _assert_streamable(cfg)
    if state is None:
        state = init_stream_state(cfg, chunks.shape[1], dtype=chunks.dtype,
                                  device=chunks.device)
    outs = []
    for chunk in chunks:
        state, out = stream_step(cfg, params, state, chunk)
        outs.append(out)
    return state, torch.stack(outs)


class StreamingSeparator:
    """A serving handle: the weights and the carried state on ``device``,
    one ``process`` call per chunk."""

    def __init__(self, cfg: ConvTasNetConfig, params: Params,
                 batch_size: int = 1, device="cuda"):
        _assert_streamable(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in params.items()}
        self.batch_size = batch_size
        self.reset()

    def process(self, chunk: torch.Tensor) -> torch.Tensor:
        """``[M, n*hop]`` new samples -> ``[M, C, n*hop]`` separated, on the
        separator's device."""
        with torch.inference_mode():
            self.state, out = stream_step(
                self.cfg, self.params, self.state,
                chunk.to(self.device, torch.float32))
        return out

    def reset(self) -> None:
        """Restart the stream (a new utterance)."""
        self.state = init_stream_state(self.cfg, self.batch_size,
                                       device=self.device)

    def flush(self) -> torch.Tensor:
        return stream_flush(self.cfg, self.state)

    @property
    def latency_samples(self) -> int:
        """Algorithmic latency: one encoder window."""
        return self.cfg.kernel_size
