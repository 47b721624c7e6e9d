"""Tensor parallelism of the dual-path (DPT) separator: its heads and its
FFN hidden width split over shards.

Counterpart of ``convtasnet_tpu/parallel/dpt_tp.py``. The split is the
Megatron pattern on each sublayer, head-aligned:

- ``W_qkv [B, 3B]`` splits by head group: shard s holds the q, k and v
  columns of heads s*h/m .. (s+1)*h/m, ``[B, 3B/m]``. q, k and v each
  split on their own; this is not a contiguous split of the [B, 3B]
  matrix, whose first shard would hold all of q;
- attention acts per head, so it runs whole on its shard;
- ``W_out [B, B]`` splits by rows, ``[B/m, B]``; the shards' partial
  projections are summed and the residual is added once;
- the FFN splits its hidden width: ``W_up [B, F/m]`` and its bias by
  columns, ``W_down [F/m, B]`` by rows; the down bias stays replicated and
  is added once, after the sum;
- every LN runs over the whole width on each shard; the encoder, input
  norm, bottleneck, positional encodings, output norm, mask head and
  decoder are replicated.

Each shard's sublayers run in ``partial`` mode (``ops/cuda/dpt_{intra,
attention,ffn}.py``): where the kernels are in use, kernels B7-B12 at the
shard's widths, their backwards through the differentiable ``fused_*_ad``
when a gradient is needed; otherwise their plain twins.

The port is single-controller, as the TCN's tensor parallelism is
(``tensor_parallel.py``): one process drives the m shard devices, the
replicated path runs once on shard 0's device, and ``all_reduce`` is the
``psum`` over the model axis. The forward slices the canonical parameters
each call, so gradients, optimizer state and checkpoints keep the
canonical layout.

Not ported (ROADMAP "Do not port"): ``ensure_probed_dpt_tp``, the
``_TP_READY`` registries and the train step's retrace on failure; here
each partial kernel runs or raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.dual_path import dual_path_forward, sublayer_fn
from convtasnet_tpu_torch.ops.cuda.dpt_attention import fitting_shards
from convtasnet_tpu_torch.parallel.tensor_parallel import (
    Variables,
    _decode,
    _encode,
    all_reduce,
    make_tp_train_step,
    use_kernels,
)

SUBLAYERS = ("intra_att", "intra_ffn", "inter_att", "inter_ffn")


def dpt_tp_variables(cfg: ConvTasNetConfig, variables: Variables,
                     devices: Sequence[torch.device]
                     ) -> List[Dict[str, torch.Tensor]]:
    """Each shard's dual-path layer leaves, ``[{state_dict key: tensor}]``,
    cut from the canonical ``variables`` and moved to the shard's device:
    ``qkv.kernel`` [B, 3B/m] by head group, ``out.kernel`` [B/m, B] and
    ``down.kernel`` [F/m, B] by rows, ``up.kernel`` [B, F/m] and
    ``up.bias`` [F/m] by columns; the norms' gamma and beta and the down
    bias whole. Shard s's slice of a leaf is JAX's ``dpt_tp_variables``
    stacked leaf [s]. Slicing, concatenation and ``.to()`` are
    differentiable, so gradients reach the canonical leaves."""
    m = len(devices)
    h, ff, B = cfg.dpt_num_heads, cfg.dpt_ff, cfg.bottleneck
    if h % m:
        raise ValueError(f"model axis {m} must divide n_heads {h} "
                         f"(head-aligned Megatron split)")
    if ff % m:
        raise ValueError(f"model axis {m} must divide dpt_ff {ff}")
    bq, fq = B // m, ff // m
    shards = []
    for s, dev in enumerate(devices):
        heads, hidden = slice(s * bq, (s + 1) * bq), slice(s * fq, (s + 1) * fq)
        leaves = {}
        for i in range(cfg.dpt_layers):
            for sub in SUBLAYERS:
                pre = f"separator.layer_{i}.{sub}."
                for leaf in ("norm.gamma", "norm.beta"):
                    leaves[pre + leaf] = variables[pre + leaf]
                if sub.endswith("att"):
                    q, k, v = variables[pre + "qkv.kernel"].split(B, dim=1)
                    leaves[pre + "qkv.kernel"] = torch.cat(
                        [q[:, heads], k[:, heads], v[:, heads]], dim=1)
                    leaves[pre + "out.kernel"] = \
                        variables[pre + "out.kernel"][heads]
                else:
                    leaves[pre + "up.kernel"] = \
                        variables[pre + "up.kernel"][:, hidden]
                    leaves[pre + "up.bias"] = variables[pre + "up.bias"][hidden]
                    leaves[pre + "down.kernel"] = \
                        variables[pre + "down.kernel"][hidden]
                    leaves[pre + "down.bias"] = variables[pre + "down.bias"]
        shards.append({k: t.to(dev) for k, t in leaves.items()})
    return shards


def _tp_att(shards, devices, pre: str, x: torch.Tensor,
            key_bias: torch.Tensor, kind: str, n_heads: int,
            use_kernel: bool) -> torch.Tensor:
    """One attention sublayer (``kind`` "intra" or "inter") on each shard's
    head group of ``n_heads`` heads, in partial mode, then the partial
    projections summed and the residual added once (``_tp_att``)."""
    parts = []
    for sh, dev in zip(shards, devices):
        args = (x.to(dev), sh[pre + "norm.gamma"], sh[pre + "norm.beta"],
                sh[pre + "qkv.kernel"], sh[pre + "out.kernel"],
                key_bias.to(dev))
        parts.append(sublayer_fn(kind, use_kernel, args)(
            *args, n_heads=n_heads, partial=True))
    return x + all_reduce(parts)


def _tp_ffn(shards, devices, pre: str, x: torch.Tensor,
            use_kernel: bool) -> torch.Tensor:
    """One FFN sublayer on each shard's hidden slice, in partial mode, then
    the partial down projections summed, and the residual and the down bias
    added once (``_tp_ffn``)."""
    M, n, S, B = x.shape
    x3 = x.reshape(M, n * S, B)
    parts = []
    for sh, dev in zip(shards, devices):
        args = (x3.to(dev), sh[pre + "norm.gamma"], sh[pre + "norm.beta"],
                sh[pre + "up.kernel"], sh[pre + "up.bias"],
                sh[pre + "down.kernel"], sh[pre + "down.bias"])
        parts.append(sublayer_fn("ffn", use_kernel, args)(*args,
                                                         partial=True))
    b_down = shards[0][pre + "down.bias"]
    return (x3 + all_reduce(parts) + b_down.to(x.dtype)).reshape(M, n, S, B)


def dpt_tp_forward(cfg: ConvTasNetConfig, variables: Variables,
                   mixture: torch.Tensor, devices: Sequence[torch.device],
                   use_pallas: Optional[bool] = None) -> torch.Tensor:
    """The dual-path model's forward with its heads and FFN hidden width
    split over ``devices`` (``mesh.shard_devices``): mixture [M, T] ->
    est_source [M, C, T] in f32 on shard 0's device, as ``ConvTasNet``
    returns it (``_dpt_tp_shard_forward``: four sums per layer).

    ``variables`` is a state_dict of the canonical model (for training,
    ``model.state_dict(keep_vars=True)``). ``use_pallas`` follows
    ``tp_forward``'s rule: None runs the partial kernels for CUDA tensors,
    True (or None with ``cfg.use_pallas``) insists on them, False runs
    their plain twins. With the kernels, a shard count whose widths they do
    not take raises, naming the counts that fit.
    """
    if cfg.separator != "dpt":
        raise ValueError("dpt_tp_forward is the dual-path separator's "
                         "tensor parallelism; for the TCN use "
                         "tensor_parallel.tp_forward")
    mixture = mixture.to(devices[0])
    m = len(devices)
    B, h, ff = cfg.bottleneck, cfg.dpt_num_heads, cfg.dpt_ff
    fits = fitting_shards(B, h, ff)
    wants_kernel = use_pallas is not False and (
        use_pallas or cfg.use_pallas or mixture.is_cuda)
    if wants_kernel and m not in fits:
        raise ValueError(
            f"the partial kernels do not take {m} shards of B={B}, {h} "
            f"heads, F={ff}: they need B/m a multiple of 64 and F/m one of "
            f"128; shard counts that fit: {fits}")
    use_kernel = use_kernels(cfg, mixture, use_pallas)
    shards = dpt_tp_variables(cfg, variables, devices)

    def run_layer(i: int, x: torch.Tensor, key_bias: torch.Tensor):
        pre = f"separator.layer_{i}."
        args = (shards, devices)
        x = _tp_att(*args, pre + "intra_att.", x, key_bias, "intra", h // m,
                    use_kernel)
        x = _tp_ffn(*args, pre + "intra_ffn.", x, use_kernel)
        x = _tp_att(*args, pre + "inter_att.", x, key_bias, "inter", h // m,
                    use_kernel)
        return _tp_ffn(*args, pre + "inter_ffn.", x, use_kernel)

    w = _encode(cfg, variables, mixture)
    leaves = {k[len("separator."):]: v for k, v in variables.items()
              if k.startswith("separator.") and ".layer_" not in k}
    mask = dual_path_forward(cfg, leaves, w, run_layer)
    return _decode(cfg, variables, w, mask, mixture.shape[-1])


def make_dpt_tp_train_step(cfg: ConvTasNetConfig,
                           devices: Sequence[torch.device]):
    """The dual-path train step through ``dpt_tp_forward`` (JAX's
    ``make_dpt_tp_train_step``): ``(state, batch) -> (state, {"loss",
    "grad_norm"})`` with ``train_step.make_train_step``'s contract, plus
    ``.multi``. Parameters, gradients and optimizer state keep the
    canonical layout; each sublayer trains through its partial kernels
    (``fused_*_ad(..., partial=True)``) where the kernels are in use."""
    if cfg.separator != "dpt":
        raise ValueError("make_dpt_tp_train_step is the dual-path "
                         "separator's; the TCN has "
                         "tensor_parallel.make_tcn_tp_train_step")
    return make_tp_train_step(cfg, devices)
